"""The port's roofline (``repro_torch.launch.roofline``), its kernels'
cost on ``meta`` (``kernels.meta_cost``), the dry run at full size and the
``tpu`` workload kind on the port's own records, against the JAX
package's where it has a counterpart.

The kernels' ``meta`` cost reproduces the bound column of ``PERF.md``'s
kernel table: the bounds ``chip_smoke.py``'s kernels line computed from
the same shapes in PR 24's final run (NVIDIA H100 80GB HBM3), each decode
row as its valid slots (a cache a row as long as its valid slots).
"""
import json

import numpy as np
import pytest
import torch

from repro.launch import roofline as ref_roofline
from repro.workloads import jobgen as ref_jobgen
from repro.workloads.registry import WorkloadSpec as RefSpec
from repro.workloads.registry import make_trace as ref_make_trace
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.kernels import meta_cost, ops
from repro_torch.launch import cost, dryrun, roofline
from repro_torch.workloads import jobgen
from repro_torch.workloads.registry import WorkloadSpec, make_trace

HBM = 3.35e12
RATE = {torch.bfloat16: 989e12, torch.float32: 67e12}


def test_hw_defaults_are_the_h100s():
    hw = roofline.HW(chips=4)
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989e12, 3.35e12, 50e9)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_collective_stats_ring_factors_equal_the_reference(kind):
    got, want = roofline.CollectiveStats(), ref_roofline.CollectiveStats()
    for nbytes, group in ((1e6, 16), (3e5, 2), (7.5e4, 1), (1.0, 512)):
        got.add(kind, nbytes, group)
        want.add(kind, nbytes, group)
    assert (got.op_bytes, got.op_counts, got.payload_bytes, got.raw_bytes) \
        == (want.op_bytes, want.op_counts, want.payload_bytes,
            want.raw_bytes)


_HLO = """
  %ag = bf16[2,16,128]{2,1,0} all-gather(%x), channel_id=1, replica_groups=[2,4]<=[8], dimensions={1}
  %ar = (f32[524288,64]{1,0}, f32[1,1048576,64]{2,1,0}) all-reduce(%a, %b), channel_id=2, replica_groups=[2,4]<=[8], to_apply=%add
  %rs = f32[16,1,64]{2,1,0} reduce-scatter(%y), channel_id=3, replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %a2a = (f32[1,1,4,8192,64]{4,3,2,1,0}, f32[1,1,4,8192,64]{4,3,2,1,0}) all-to-all(%c, %d), channel_id=4
  %cp = f32[16,6,64]{2,1,0} collective-permute(%z), channel_id=5, source_target_pairs={{1,0},{2,1}}
  %ags = s8[4096]{0} all-gather-start(%w), channel_id=6, replica_groups={{0,1}}
  %other = f32[8]{0} add(%p, %q)
"""


@pytest.mark.parametrize("devices", [8, 256, 512])
def test_parse_collectives_equals_the_reference(devices):
    got = roofline.parse_collectives(_HLO, devices)
    want = ref_roofline.parse_collectives(_HLO, devices)
    assert got.op_counts == want.op_counts == {
        "all-gather": 2, "all-reduce": 1, "reduce-scatter": 1,
        "all-to-all": 1, "collective-permute": 1}
    assert (got.op_bytes, got.payload_bytes, got.raw_bytes) == \
        (want.op_bytes, want.payload_bytes, want.raw_bytes)


@pytest.mark.parametrize("seed", range(4))
def test_roofline_terms_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    flops, nbytes, payload = (float(x) for x in 10 ** rng.uniform(6, 16, 3))
    chips = int(rng.integers(1, 513))
    kw = dict(chips=chips, peak_flops=1e14, hbm_bw=1e12, ici_bw=1e11)
    got = roofline.roofline_terms(flops, nbytes, roofline.CollectiveStats(
        payload_bytes=payload), roofline.HW(**kw))
    want = ref_roofline.roofline_terms(
        flops, nbytes, ref_roofline.CollectiveStats(payload_bytes=payload),
        ref_roofline.HW(**kw))
    assert got == want


# --------------------------------------------------------------------------- #
# the kernels' cost on meta                                                   #
# --------------------------------------------------------------------------- #
def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _charged(fn, *args, **kw):
    with cost.CostTrace() as tr:
        out = fn(*args, **kw)
    assert all(t.device.type == "meta" for t in (out if isinstance(
        out, tuple) else (out,)))
    return tr


def _bound_ms(flops, nbytes, dtype):
    return max(nbytes / HBM, flops / RATE[dtype]) * 1e3


# (name, (B, Tq, H, Hkv, hd, hdv, Tk), causal, window, scale, dtype,
#  PR 24's bound ms)
PREFILL = [
    ("recurrentgemma", (1, 1374, 10, 1, 256, 256, 1374), True, 2048, None,
     torch.bfloat16, 0.009780546006066735),
    ("llama3", (1, 1540, 32, 8, 128, 128, 1540), True, 0, None,
     torch.bfloat16, 0.01965698976744186),
    ("qwen_moe", (1, 1525, 16, 16, 128, 128, 1525), True, 0, None,
     torch.bfloat16, 0.009638024671385238),
    ("mla", (1, 1556, 128, 128, 192, 128, 1556), True, 0, 192 ** -0.5,
     torch.bfloat16, 0.10033717322548028),
    ("whisper_decoder", (1, 200, 20, 20, 64, 64, 200), True, 0, None,
     torch.bfloat16, 0.0006113432835820895),
    ("whisper_encoder", (1, 1500, 20, 20, 64, 64, 1500), False, 0, None,
     torch.bfloat16, 0.011648129423660263),
    ("whisper_cross", (1, 200, 20, 20, 64, 64, 1500), False, 0, None,
     torch.bfloat16, 0.0025982089552238803),
    ("internvl2", (1, 1795, 64, 8, 128, 128, 1795), True, 0, None,
     torch.bfloat16, 0.05340653880687563),
    # training SmolLM-360M, fp32, against FP32 67 TFLOP/s (PERF.md: 0.120)
    ("smollm_train", (4, 1024, 15, 5, 64, 64, 1024), True, 0, None,
     torch.float32, 0.12031235820895522),
]


@pytest.mark.parametrize("case", PREFILL, ids=[c[0] for c in PREFILL])
def test_attention_meta_cost_reproduces_the_bound(case):
    _, (B, Tq, H, Hkv, hd, hdv, Tk), causal, win, scale, dtype, want = case
    q, k, v = (_meta((B, Tq, H, hd), dtype), _meta((B, Tk, Hkv, hd), dtype),
               _meta((B, Tk, Hkv, hdv), dtype))
    tr = _charged(ops.flash_attention, q, k, v, causal=causal, window=win,
                  scale=scale)
    c = tr.kernels["flash_attention"]
    assert c["calls"] == 1 and tr.ops > 0
    assert _bound_ms(c["flops"], c["bytes"], dtype) == pytest.approx(
        want, rel=1e-9)
    assert sum(ops.launches.values()) == 0


def test_llama_prefill_counts_1_94e10_operations():
    q, k, v = (_meta((1, 1540, 32, 128)), _meta((1, 1540, 8, 128)),
               _meta((1, 1540, 8, 128)))
    flops, _ = meta_cost.attention_cost(q, k, v, True, 0, 0)
    assert flops == 2 * 256 * 32 * (1540 * 1541 // 2)
    assert flops / 989e12 * 1e3 == pytest.approx(0.0197, abs=5e-5)


# (name, S, H, Hkv, hd, valid lens a row as served, PR 24's bound ms)
DECODE = [
    ("recurrentgemma", 2048, 10, 1, 256, [1242, 1388, 1456, 1098],
     0.0015980513432835822),
    ("llama3", 4096, 32, 8, 128, [1942, 1775, 1057, 1073],
     0.007173502089552239),
    ("qwen_moe", 4096, 16, 16, 128, [1696, 1419, 1150, 1722],
     0.014660011940298506),
    ("whisper_self", 512, 20, 20, 64, [240, 288, 404, 120],
     0.0016200597014925373),
    ("whisper_cross", 1500, 20, 20, 64, [1500] * 4, 0.009176262686567165),
    ("internvl2", 4096, 64, 8, 128, [1973, 2002, 1650, 1570],
     0.008841246567164179),
]


@pytest.mark.parametrize("case", DECODE, ids=[c[0] for c in DECODE])
def test_decode_meta_cost_reproduces_the_bound(case):
    """Each row over a cache as long as its valid slots, ``cur_len`` a
    tensor (every slot counts, as the dry run's abstract position)."""
    _, S, H, Hkv, hd, lens, want = case
    flops = nbytes = 0.0
    for n in lens:
        valid = min(n + 1, S)
        tr = _charged(ops.flash_decode, _meta((1, H, hd)),
                      _meta((1, valid, Hkv, hd)), _meta((1, valid, Hkv, hd)),
                      torch.empty((1,), dtype=torch.int64, device="meta"))
        flops += tr.kernels["flash_decode"]["flops"]
        nbytes += tr.kernels["flash_decode"]["bytes"]
    assert _bound_ms(flops, nbytes, torch.bfloat16) == pytest.approx(
        want, rel=1e-9)


# (name, (B, T, H, dk, dv), dtype of r k v, PR 24's bound ms)
WKV = [("sequential", (4, 1, 64, 64, 64), 0.0025774232835820894),
       ("chunked", (1, 1428, 64, 64, 64), 0.028372441791044777)]


@pytest.mark.parametrize("case", WKV, ids=[c[0] for c in WKV])
def test_wkv6_meta_cost_reproduces_the_bound(case):
    _, (B, T, H, dk, dv), want = case
    bf, f32 = torch.bfloat16, torch.float32
    tr = _charged(ops.wkv6, _meta((B, T, H, dk), bf), _meta((B, T, H, dk), bf),
                  _meta((B, T, H, dv), bf), _meta((B, T, H, dk), f32),
                  _meta((H, dk), f32), _meta((B, H, dk, dv), f32))
    c = tr.kernels["wkv6"]
    assert _bound_ms(c["flops"], c["bytes"], f32) == pytest.approx(
        want, rel=1e-9)


RGLRU = [("sequential", (4, 1, 2560), 6.113432835820896e-05),
         ("chunked", (1, 1374, 2560), 0.012605898507462687)]


@pytest.mark.parametrize("case", RGLRU, ids=[c[0] for c in RGLRU])
def test_rglru_meta_cost_reproduces_the_bound(case):
    _, (B, T, W), want = case
    f32 = torch.float32
    h, hT = None, None
    with cost.CostTrace() as tr:
        h, hT = ops.linear_recurrence(_meta((B, T, W), f32),
                                      _meta((B, T, W), f32),
                                      _meta((B, W), f32))
    assert tuple(h.shape) == (B, T, W) and tuple(hT.shape) == (B, W)
    c = tr.kernels["rglru_scan"]
    assert _bound_ms(c["flops"], c["bytes"], f32) == pytest.approx(
        want, rel=1e-9)


def test_meta_kernels_differentiate_and_charge_their_backward():
    q = _meta((2, 64, 4, 16), torch.float32).requires_grad_(True)
    k = _meta((2, 64, 2, 16), torch.float32).requires_grad_(True)
    v = _meta((2, 64, 2, 16), torch.float32).requires_grad_(True)
    with cost.CostTrace() as tr:
        o = ops.flash_attention(q, k, v)
        gq, gk, gv = torch.autograd.grad(o.sum(), (q, k, v))
    fwd, bwd = tr.kernels["flash_attention"], \
        tr.kernels["flash_attention backward"]
    assert (bwd["flops"], bwd["bytes"]) == (2 * fwd["flops"],
                                            2 * fwd["bytes"])
    assert gq.shape == q.shape and gk.shape == k.shape and gv.shape == v.shape


def test_allocation_kernels_refuse_meta():
    w = torch.empty((2, 4, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        ops.alloc_matvec(w, torch.empty((2, 3), dtype=torch.float64,
                                        device="meta"))


# --------------------------------------------------------------------------- #
# the dry run at full size, and its records through the tpu kind             #
# --------------------------------------------------------------------------- #
FULL = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.fixture(scope="module")
def full_size(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    recs = {(a, s): dryrun.run_cell(a, s, False, out_dir=str(out),
                                    verbose=False) for a, s in FULL}
    return out, recs


@pytest.mark.parametrize("cell", FULL, ids=[f"{a}-{s}" for a, s in FULL])
def test_run_cell_at_full_size_on_meta(cell, full_size):
    out, recs = full_size
    rec = recs[cell]
    ok, why = shape_applicable(get_config(cell[0]), SHAPES[cell[1]])
    assert rec["status"] == ("ok" if ok else "skipped")
    with open(out / f"{cell[0]}__{cell[1]}__single.json") as f:
        assert json.load(f)["status"] == rec["status"]
    if not ok:
        assert rec["reason"] == why
        return
    assert rec["chips"] == 256 and rec["extrapolated"]
    terms = rec["roofline"]
    assert terms["step_s"] == max(terms["compute_s"], terms["memory_s"],
                                  terms["collective_s"]) > 0
    assert roofline.bytes_per_chip(rec) > 0


def test_records_through_the_tpu_kind_equal_in_both_packages(full_size,
                                                             tmp_path):
    """The port's flat records give the same job types and traces in both
    packages' ``jobgen``, and through both registries' ``tpu`` kind."""
    out, _ = full_size
    flat = roofline.jobgen_records("single", str(out))
    assert len(flat) == sum(shape_applicable(get_config(a), SHAPES[s])[0]
                            for a, s in FULL)
    types = jobgen.tpu_job_types(flat)
    want = ref_jobgen.tpu_job_types(flat)
    assert [t.__dict__ for t in types] == [t.__dict__ for t in want]
    got_tr = jobgen.tpu_trace(types, n_jobs=200, n_nodes=128, seed=0,
                              target_load=0.7)
    want_tr = ref_jobgen.tpu_trace(want, n_jobs=200, n_nodes=128, seed=0,
                                   target_load=0.7)
    assert [j.__dict__ for j in got_tr] == [j.__dict__ for j in want_tr]
    path = tmp_path / "records.json"
    path.write_text(json.dumps(flat))
    kw = dict(n_jobs=200, n_nodes=128, seed=0, load=0.7,
              params={"records": str(path)})
    a = make_trace(WorkloadSpec("tpu", **kw))
    b = ref_make_trace(RefSpec("tpu", **kw))
    assert len(a) == len(b) == 200
    for x, y in zip(a, b):
        assert x.__dict__ == y.__dict__
