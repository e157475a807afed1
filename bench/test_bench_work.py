"""The frozen FLOP and byte arithmetic against counts worked by hand for
both cells' shapes, and the metric readers on hand-made records."""
import pytest

from bench import common, peaks
from bench.work import transformer as work
from bench import drive_train

SMOL = common.cell("smollm-360m.pretrain")
WHISPER = common.cell("whisper-large-v3.finetune")


def test_smollm_train_flops():
    c = SMOL
    # a layer's matrices: q 960x960, k and v 960x320, o 960x960
    # (2,457,600), gate, up and down 3 x 960 x 2,560 (7,372,800)
    layer = 2_457_600 + 7_372_800
    matmul = 8 * 2048 * 32 * layer + 8 * 2047 * 960 * 49_152
    # causal pairs 2,048 x 2,049 / 2 = 2,098,176; 4 x 64 FLOPs a pair,
    # 8 rows, 15 heads, 32 layers
    attn = 32 * 4 * 64 * 8 * 15 * 2_098_176
    assert work.train_flops(c["config"]["model"], c["traffic"]) == \
        6 * matmul + 3 * attn
    assert 6 * matmul + 3 * attn == 41_747_837_091_840


def test_whisper_train_flops():
    c = WHISPER
    D, Fd = 1280, 5120
    enc_layer = 4 * D * D + 2 * D * Fd          # 6,553,600 + 13,107,200
    dec_layer = 4 * D * D + 2 * D * Fd
    cross = 8 * 448 * 2 * D * D + 8 * 1500 * 2 * D * D   # Q, O / K, V
    matmul = (8 * 1500 * 32 * enc_layer + 8 * 448 * 32 * dec_layer
              + 32 * cross + 8 * 447 * D * 51_866)
    attn = 4 * 64 * 8 * 20 * (32 * 1500 * 1500 + 32 * 448 * 449 // 2
                               + 32 * 448 * 1500)
    assert work.train_flops(c["config"]["model"], c["traffic"]) == \
        6 * matmul + 3 * attn
    assert 6 * matmul + 3 * attn == 81_941_918_883_840


def test_attention_calls():
    smol = work.attention_calls(SMOL["config"]["model"], SMOL["traffic"])
    assert [(c["name"], c["count"]) for c in smol] == [("decoder self", 32)]
    assert smol[0]["flops"] == 4 * 64 * 8 * 15 * 2_098_176
    # Q and O: 8 x 2,048 x 15 x 64; K and V: 8 x 2,048 x 5 x 64; fp32
    assert smol[0]["bytes"] == 4 * (2 * 15_728_640 + 2 * 5_242_880)
    wh = {c["name"]: c for c in work.attention_calls(
        WHISPER["config"]["model"], WHISPER["traffic"])}
    assert wh["encoder self"]["flops"] == 4 * 64 * 8 * 20 * 1500 * 1500
    assert wh["cross"]["flops"] == 4 * 64 * 8 * 20 * 448 * 1500
    assert wh["cross"]["bytes"] == 4 * 8 * 64 * (2 * 448 * 20 + 2 * 1500 * 20)
    assert wh["decoder self"]["flops"] == 4 * 64 * 8 * 20 * 448 * 449 // 2
    assert sorted(c["count"] for c in wh.values()) == [32, 32, 32]


def _rec(**kw):
    rec = {"steps": 10, "window_s": 20.0, "train_flops": 4e13,
           "attention_calls": work.attention_calls(SMOL["config"]["model"],
                                                   SMOL["traffic"]),
           "peaks": peaks.PEAKS["NVIDIA H100 80GB HBM3"],
           "device": {"busy_s": 18.0, "events": 1000, "by_name": {
               "void attn_tf32x3_kernel<32, 64, 128>(AttnArgs, int, float)":
                   0.5, "sm80_xmma_gemm_f32f32": 15.0,
               "void decode_kernel<float>(DecodeArgs)": 1.0}},
           "host_ops_per_step": 1234}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("metric", ["train_mfu", "attn_roofline",
                                    "device_idle", "host_ops_per_step"])
def test_readers(metric):
    reader = common.load_module(common.BENCH / "metrics" / f"{metric}.py")
    got = reader.read(_rec())
    want = {"train_mfu": 100 * 10 * 4e13 / 20.0 / 495e12,
            "attn_roofline": 100 * 10 * 32 * (4 * 64 * 8 * 15 * 2_098_176)
            / 495e12 / 0.5,
            "device_idle": 10.0, "host_ops_per_step": 1234}[metric]
    assert got == pytest.approx(want, rel=1e-12)


def test_attn_roofline_finds_nothing_without_its_kernels():
    reader = common.load_module(common.BENCH / "metrics" / "attn_roofline.py")
    rec = _rec(device={"busy_s": 1.0, "events": 1,
                       "by_name": {"sm80_xmma_gemm_f32f32": 1.0}})
    assert reader.read(rec) is None


def test_per_layer_names_every_metric():
    rec = _rec()
    out = drive_train.per_layer(SMOL, rec)
    assert sorted(out) == sorted(
        m["name"] for m in common.benchmark()["per_layer"]
        if SMOL["workload"]["name"] in m["workloads"])
    assert sorted(drive_train.end_to_end(WHISPER, {
        "setup_s": 1.0, "train_tokens_s": 2.0, "peak_mem_gib": 3.0})) == [
        "peak_mem_gib", "setup_s", "train_tokens_s.encdec"]
