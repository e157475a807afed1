"""``make_train_step`` of the port against the JAX package's on the CPU
for the other ported families, once each, the combinations spread so that
every family runs one and every option runs on more than one family:
3 steps from the same weights on the same tokens, compared as in
``test_torch_train_step.py`` (``train_compare.check_step_run``).  The MoE
family's runs carry the auxiliary loss, and DeepSeek-V3's the MTP loss,
in the metrics compared; their expert leaves (count, E, D, F) are
factored over (D, F) in both packages.
"""
import pytest

pytest.importorskip("jax")

from train_compare import check_step_run, run_both  # noqa: E402

CASES = [("llama3-8b", 1, False, False), ("qwen3-8b", 2, False, True),
         ("granite-3-2b", 1, True, True), ("recurrentgemma-2b", 2, True, False),
         ("rwkv6-7b", 1, False, False), ("rwkv6-7b", 2, True, True),
         ("qwen2-moe-a2.7b", 2, True, False),
         ("deepseek-v3-671b", 1, False, True)]


@pytest.mark.parametrize(
    "arch,microbatches,factored,compress", CASES,
    ids=[f"{a}-mb{mb}-{'adafactor' if fac else 'adamw'}-"
         f"{'int8' if comp else 'fp32'}" for a, mb, fac, comp in CASES])
def test_three_steps_equal_the_reference(arch, microbatches, factored,
                                         compress):
    jm, js, tm, ts = run_both(arch, microbatches, factored, compress)
    check_step_run(jm, js, tm, ts, factored, compress)
