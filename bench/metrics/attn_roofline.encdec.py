"""``attn_roofline`` of the encoder-decoder cells, whose end-to-end rate is
``train_tokens_s.encdec``: the same reader."""
from bench.metrics.attn_roofline import read  # noqa: F401
