"""``device_idle`` of the encoder-decoder cells, whose end-to-end rate is
``train_tokens_s.encdec``: the same reader."""
from bench.metrics.device_idle import read  # noqa: F401
