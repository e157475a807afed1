"""The model substrate's serving and training paths, ported: ``config``
(every family's ``ModelConfig``), ``layers`` and ``blocks`` (attention,
RWKV6, RG-LRU, MLP), ``backbone`` (init in either parameter layout, the
layer loop, the training loss, prefill, decode) and ``convert`` (the
reference's parameters carried across).  Per-arch configs live in
``repro_torch.configs``."""
from .config import ModelConfig, reduce_config  # noqa: F401
