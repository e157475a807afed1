"""``train_mfu`` of the encoder-decoder cells, whose end-to-end rate is
``train_tokens_s.encdec``: the same reader."""
from bench.metrics.train_mfu import read  # noqa: F401
