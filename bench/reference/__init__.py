"""Plain fp32 PyTorch references of the benchmark's configurations.  They
import nothing of the program (``repro_torch``) nor the JAX package."""
