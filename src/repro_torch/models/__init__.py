"""The model substrate's serving and training paths, ported: ``config``
(every family's ``ModelConfig``), ``layers`` and ``blocks`` (attention,
DeepSeek's MLA, RWKV6, RG-LRU, MLP), ``moe`` (routed and shared experts
with sort-based dispatch and the auxiliary loss), ``backbone`` (init in
either parameter layout, the layer loop, the training loss with the MoE
and MTP terms, prefill, decode) and ``convert`` (the reference's
parameters carried across).  Per-arch configs live in
``repro_torch.configs``."""
from . import backbone, blocks, config, layers, moe  # noqa: F401
from .config import ModelConfig, reduce_config  # noqa: F401
