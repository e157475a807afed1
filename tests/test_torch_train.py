"""The training substrate of the port (optimizer, compression, data,
checkpoint, the restartable loop, the launcher) on the CPU, against the
JAX package where the two compute the same thing.

* The optimizers get the same seeded gradients in both packages, step
  after step from the same state, on toy trees and on reduced models'
  trees in the training layout: every leaf within atol = rtol = 1e-4,
  Adafactor's bf16 first moment within one bf16 rounding step more.
* The stacked-leaf rules the port mirrors: a layer's norm vector is a
  ``(count, D)`` leaf, so it is decayed (the top-level ``final_norm`` is
  not) and, when ``count > 1``, factored across layers.
* ``compress_int8`` equals the reference's bit for bit on the same input;
  the error-feedback invariant holds.
* Data, checkpoints, ``run_restartable`` and the launcher: the reference's
  contracts (``tests/test_train.py``), on the port alone.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import backbone  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compression, optimizer  # noqa: E402
from repro_torch.train.data import data_for  # noqa: E402
from repro_torch.train.ft import (FailureInjector, InjectedFailure,  # noqa: E402
                                  StragglerStats, run_restartable)
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainer import (init_train_state,  # noqa: E402
                                       make_eval_step, make_train_step)
from repro_torch.train.tree import flatten, leaves, tree_map  # noqa: E402

from train_compare import (TOL, assert_tree_close, jax_tree,  # noqa: E402
                           model)

ROOT = Path(__file__).resolve().parents[1]
CFG = get_reduced("smollm-360m")


def _seeded_like(tree, seed, scale=1.0):
    """Seeded normal numpy arrays shaped as the leaves of a JAX tree,
    leaf scales spread over four decades."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (scale * 10.0 ** rng.uniform(-3, 0)
                   * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree)


def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # exact through fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _t(tree):
    return jax.tree.map(_tensor, tree)


# --------------------------------------------------------------------------- #
# optimizer                                                                    #
# --------------------------------------------------------------------------- #
def _check_optimizers(tree, factored, steps=3, **opt):
    """``steps`` updates of both packages' optimizer on the same seeded
    gradients, each step from the reference's state of the step before
    (carried across), compared after every step: the metrics, the
    parameters and the state."""
    jcfg = jopt.OptConfig(factored=factored, **opt)
    tcfg = OptConfig(factored=factored, **opt)
    jp = jax_tree(tree)
    js = jopt.init_opt_state(jp, factored)
    jupdate = jax.jit(lambda p, g, s: jopt.update(jcfg, p, g, s))
    for i in range(steps):
        g = _seeded_like(tree, 100 + i)
        ts = optimizer.OptState(torch.tensor(int(js.step), dtype=torch.int32),
                                _t(js.mu), _t(js.nu))
        tp, ts, tm = optimizer.update(tcfg, _t(jp), _t(g), ts)
        jp, js, jm = jupdate(jp, jax_tree(g), js)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                       atol=TOL)
        assert int(ts.step) == int(js.step) == i + 1
        assert_tree_close(jp, tp)
        assert_tree_close(js.mu, ts.mu)
        assert_tree_close(js.nu, ts.nu)


def _toy():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": np.zeros((4,), np.float32),
            "stack": [rng.standard_normal((3, 5, 6)).astype(np.float32),
                      rng.standard_normal((1, 6)).astype(np.float32)]}


@pytest.mark.parametrize("factored", [False, True],
                         ids=["adamw", "adafactor"])
@pytest.mark.parametrize("tree_name", ["toy", "smollm-360m",
                                       "recurrentgemma-2b"])
def test_optimizer_equals_the_reference_on_the_same_gradients(tree_name,
                                                              factored):
    tree = _toy() if tree_name == "toy" else model(tree_name)[1]
    _check_optimizers(tree, factored, lr=1e-2, warmup_steps=1,
                      total_steps=6, clip_norm=5.0)


def test_optimizer_descends_a_quadratic():
    for factored, n in ((False, 50), (True, 60)):
        cfg = OptConfig(lr=0.1, warmup_steps=0, weight_decay=0.0,
                        total_steps=100, factored=factored)
        params = {"w": torch.ones((8, 4)), "b": torch.zeros((4,))}
        state = optimizer.init_opt_state(params, factored)
        for _ in range(n):
            params, state, m = optimizer.update(
                cfg, params, {k: 2 * v for k, v in params.items()}, state)
        loss = sum(float((v ** 2).sum()) for v in params.values())
        assert loss < (1e-2 if not factored else 0.05)
        assert int(state.step) == n
    assert state.mu["w"].dtype == torch.bfloat16
    assert state.nu["w"]["vr"].shape == (8,)
    assert state.nu["w"]["vc"].shape == (4,)
    assert state.nu["b"].shape == (4,)


def test_stacked_norm_vectors_are_decayed_and_factored_as_in_the_reference():
    """The reference decides decay (ndim >= 2) and factoring (last two
    axes > 1) per stacked group leaf: a layer's norm vector (count, D) is
    decayed and, with count > 1, factored across layers; the top-level
    ``final_norm`` (D,) is neither; a group of one's norm (1, D) is
    decayed, not factored.  The port mirrors all of it."""
    _, tree, pcfg, params = model("recurrentgemma-2b")   # groups of 2 and 1
    rec, att = params["groups"][0], params["groups"][1]
    assert rec["mix"]["ln"].shape == (2, pcfg.d_model)
    assert att["mix"]["ln"].shape == (1, pcfg.d_model)
    jst = jax.eval_shape(lambda p: jopt.init_opt_state(p, factored=True),
                         jax_tree(tree))
    st = optimizer.init_opt_state(params, factored=True)
    assert set(st.nu["groups"][0]["mix"]["ln"]) == {"vr", "vc"}
    assert st.nu["groups"][0]["mix"]["ln"]["vr"].shape == (2,)
    assert isinstance(jst.nu["groups"][0]["mix"]["ln"], dict)
    assert st.nu["groups"][1]["mix"]["ln"].shape == (1, pcfg.d_model)
    assert st.nu["final_norm"].shape == (pcfg.d_model,)
    # zero gradients after warmup: only the decay moves a leaf
    cfg = dict(lr=0.5, warmup_steps=0, total_steps=10, weight_decay=0.1)
    zeros = jax.tree.map(np.zeros_like, tree)
    for factored in (False, True):
        jcfg = jopt.OptConfig(factored=factored, **cfg)
        jp, _, _ = jax.jit(lambda p, g: jopt.update(
            jcfg, p, g, jopt.init_opt_state(p, factored)))(
            jax_tree(tree), jax_tree(zeros))
        tp, _, _ = optimizer.update(OptConfig(factored=factored, **cfg),
                                    params, _t(zeros),
                                    optimizer.init_opt_state(params,
                                                             factored))
        assert_tree_close(jp, tp)
        assert torch.equal(tp["final_norm"], params["final_norm"])
        for g in (0, 1):
            ln, ln0 = (tp["groups"][g]["mix"]["ln"],
                       params["groups"][g]["mix"]["ln"])
            torch.testing.assert_close(ln, ln0 * (1 - 0.5 * 0.1))


def test_lr_schedule_and_global_norm_equal_the_reference():
    jcfg = jopt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    tcfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                     min_lr_frac=0.1)
    for s in (0, 1, 5, 9, 10, 11, 55, 99, 100, 200):
        want = float(jopt.lr_schedule(jcfg, jnp.int32(s)))
        got = optimizer.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)
    assert float(optimizer.lr_schedule(
        tcfg, torch.tensor(0, dtype=torch.int32))) == 0.0
    tree = _seeded_like(_toy(), 5)
    np.testing.assert_allclose(float(optimizer.global_norm(_t(tree))),
                               float(jopt.global_norm(jax_tree(tree))),
                               rtol=1e-6)


def test_gradient_clipping_bounds_the_update():
    cfg = OptConfig(lr=1.0, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros((4,))}
    _, _, m = optimizer.adamw_update(cfg, params, {"w": torch.full((4,), 1e6)},
                                     optimizer.init_opt_state(params))
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


# --------------------------------------------------------------------------- #
# compression                                                                  #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_int8_compression_equals_the_reference_bit_for_bit(seed):
    tree = _seeded_like(_toy(), seed, scale=100.0)
    tree["stack"][1][0, :3] = 0.0
    jc, jerr = jcomp.compress_int8(jax_tree(tree))
    tc, terr = compression.compress_int8(_t(tree))
    for a, b in zip(jax.tree.leaves(jc.q), leaves(tc.q)):
        assert b.dtype == torch.int8
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree.leaves(jc.scale), leaves(tc.scale)):
        assert b.dim() == 0 and float(b) == float(a)
    for a, b in zip(jax.tree.leaves(jerr), leaves(terr)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    deq = compression.decompress_int8(tc)
    for a, b in zip(jax.tree.leaves(jcomp.decompress_int8(jc)), leaves(deq)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("seed", range(6))
def test_int8_error_feedback_invariant(seed):
    """decompress(compress(g)) + err == g, the error within half a step."""
    rng = np.random.default_rng(seed)
    g = {"a": torch.from_numpy(rng.normal(size=(16, 8))
                               * rng.uniform(0.1, 100)),
         "b": torch.from_numpy(rng.normal(size=(5,)))}
    comp, err = compression.compress_int8(g)
    deq = compression.decompress_int8(comp)
    for k in g:
        np.testing.assert_allclose((deq[k] + err[k]).numpy(),
                                   g[k].float().numpy(), rtol=1e-6, atol=1e-6)
        assert comp.q[k].dtype == torch.int8
        assert float(err[k].abs().max()) <= float(comp.scale[k]) * 0.5 + 1e-6


def test_round_half_to_even_as_jnp_round():
    g = {"x": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5])}
    q = compression.compress_int8(g)[0].q["x"]
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 64]


# --------------------------------------------------------------------------- #
# data                                                                         #
# --------------------------------------------------------------------------- #
def test_data_deterministic_and_restart_safe():
    d1 = data_for(CFG, 4, 64, seed=3, device="cpu")
    d2 = data_for(CFG, 4, 64, seed=3, device="cpu")
    b1, b2 = d1.batch_for_step(17), d2.batch_for_step(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(d1.batch_for_step(17)["tokens"], b1["tokens"])
    assert not torch.equal(b1["tokens"], d1.batch_for_step(18)["tokens"])
    assert not torch.equal(b1["tokens"], data_for(
        CFG, 4, 64, seed=4, device="cpu").batch_for_step(17)["tokens"])
    assert int(b1["tokens"].max()) < CFG.vocab and int(b1["tokens"].min()) >= 0
    assert next(iter(d1))["tokens"].equal(d1.batch_for_step(0)["tokens"])


def test_data_bos_every_doc_len_and_zipf_rank_order():
    d = data_for(CFG, 8, 1100, seed=0, device="cpu")
    toks = d.batch_for_step(0)["tokens"]
    assert d.cfg.doc_len == 512
    pos = torch.arange(1100)
    assert (toks[:, pos % 512 == 0] == 0).all()
    body = toks[:, pos % 512 != 0].flatten()
    counts = torch.bincount(body, minlength=CFG.vocab)
    # probability ~ rank^-1.2: token 0 most frequent, then falling
    assert counts[0] > counts[1] > counts[4] > counts[30]
    assert counts[0] / counts[9] == pytest.approx(10 ** 1.2, rel=0.25)


def test_data_frontend_extras():
    enc = dataclasses.replace(CFG, encoder_layers=2)
    b = data_for(enc, 2, 32, n_enc=16, device="cpu").batch_for_step(0)
    assert b["enc_embeds"].shape == (2, 16, CFG.d_model)
    vis = dataclasses.replace(CFG, frontend="vision", n_frontend_tokens=8)
    b = data_for(vis, 2, 32, device="cpu").batch_for_step(0)
    assert b["vision_embeds"].shape == (2, 8, CFG.d_model)
    assert "enc_embeds" not in data_for(CFG, 2, 32, device="cpu") \
        .batch_for_step(0)


# --------------------------------------------------------------------------- #
# checkpoint                                                                   #
# --------------------------------------------------------------------------- #
def _state(factored=True, compress=False):
    return init_train_state(CFG, torch.Generator().manual_seed(0),
                            factored=factored, compress=compress,
                            device="cpu")


def _one_step(state, factored=True):
    step = make_train_step(CFG, OptConfig(lr=1e-3, warmup_steps=0,
                                          factored=factored))
    return step(state, data_for(CFG, 2, 16, device="cpu").batch_for_step(0))


def test_checkpoint_roundtrip_bit_for_bit_with_bf16_leaves(tmp_path):
    state, _ = _one_step(_state())
    assert state.opt.mu["embed"].dtype == torch.bfloat16
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 5, state, metadata={"loss": 1.0})
    ckpt.save(d, 10, state)
    assert ckpt.latest_step(d) == 10
    step, restored, meta = ckpt.restore(d, template=_state(), step=5)
    assert step == 5 and meta["loss"] == 1.0
    a, sa = flatten(state)
    b, sb = flatten(restored)
    assert repr(sa) == repr(sb) and type(restored) is type(state)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    raw = ckpt.restore(d)[1]                 # no template: stored leaves
    assert [t.dtype for t in raw] == [t.dtype for t in a]
    with open(os.path.join(d, "step_000000010", "manifest.json")) as f:
        assert '"bfloat16"' in f.read()


def test_checkpoint_restores_onto_the_template_dtype_and_device(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    ckpt.save(str(tmp_path), 1, tree)
    _, out, _ = ckpt.restore(str(tmp_path),
                             template={"w": torch.zeros(2, 3,
                                                        dtype=torch.float64)})
    assert out["w"].dtype == torch.float64
    assert out["w"].tolist() == tree["w"].tolist()


def test_checkpoint_rejects_shape_mismatch(tmp_path):
    state = _state(factored=False)
    ckpt.save(str(tmp_path), 1, state)
    bad = tree_map(lambda x: torch.zeros((3, 3)), state)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), template=bad)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), template={"x": torch.zeros(1)})


def test_latest_is_written_only_after_the_commit(tmp_path, monkeypatch):
    d = str(tmp_path)
    ckpt.save(d, 1, {"x": torch.ones(3)})

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt.np, "savez", broken)
    with pytest.raises(OSError):
        ckpt.save(d, 2, {"x": torch.ones(3)})
    assert ckpt.latest_step(d) == 1
    assert sorted(os.listdir(d)) == ["LATEST", "step_000000001"]


def test_save_async_copies_before_returning(tmp_path):
    x = torch.arange(10, dtype=torch.float32)
    ckpt.save_async(str(tmp_path), 7, {"x": x})
    x.add_(100.0)                  # an in-place update right after
    ckpt.wait_pending()
    step, restored, _ = ckpt.restore(str(tmp_path),
                                     template={"x": torch.zeros(10)})
    assert step == 7
    assert restored["x"].tolist() == list(range(10))


# --------------------------------------------------------------------------- #
# the restartable loop                                                         #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("compress", [False, True], ids=["fp32", "int8"])
def test_restartable_run_equals_the_clean_run(tmp_path, compress):
    """Failures at steps 6 and 9, checkpoints every 4: two restarts, from
    steps 4 and 8, and the same losses and final state as an uninterrupted
    run, bit for bit on the CPU."""
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    step = make_train_step(CFG, opt, compress_grads=compress)
    data = data_for(CFG, 4, 32, device="cpu")

    def mk():
        return init_train_state(CFG, torch.Generator().manual_seed(0),
                                compress=compress, device="cpu")
    clean = run_restartable(step, mk, data.batch_for_step, 12,
                            str(tmp_path / "a"), ckpt_every=4)
    faulty = run_restartable(step, mk, data.batch_for_step, 12,
                             str(tmp_path / "b"), ckpt_every=4,
                             injector=FailureInjector(at_steps=(6, 9)))
    assert clean.n_restarts == 0 and faulty.n_restarts == 2
    assert faulty.restored_from == [4, 8] and faulty.final_step == 12
    assert faulty.losses[-1] == clean.losses[-1]
    assert faulty.losses[:6] == clean.losses[:6]
    _, a, _ = ckpt.restore(str(tmp_path / "a"), template=mk())
    _, b, _ = ckpt.restore(str(tmp_path / "b"), template=mk())
    for x, y in zip(flatten(a)[0], flatten(b)[0]):
        assert torch.equal(x, y)


def test_restartable_run_gives_up_after_max_restarts(tmp_path):
    step = make_train_step(CFG, OptConfig())
    data = data_for(CFG, 2, 16, device="cpu")

    def mk():
        return init_train_state(CFG, torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises(InjectedFailure):
        run_restartable(step, mk, data.batch_for_step, 4, str(tmp_path),
                        ckpt_every=1, max_restarts=1,
                        injector=FailureInjector(at_steps=(1, 2)))


def test_straggler_detection():
    s = StragglerStats()
    for _ in range(10):
        s.observe(0.1, factor=3.0)
    assert not s.observe(0.15, factor=3.0)
    assert s.observe(1.0, factor=3.0)       # 10x the EMA
    assert s.n_stragglers == 1
    assert s.worst_ratio > 3.0


def test_eval_step_is_the_loss_without_gradients():
    state = _state(factored=False)
    batch = data_for(CFG, 2, 16, device="cpu").batch_for_step(3)
    out = make_eval_step(CFG)(state.params, batch)
    want, _ = backbone.lm_loss(CFG, state.params, batch)
    assert set(out) == {"loss", "xent", "aux"}
    assert not out["loss"].requires_grad
    assert float(out["loss"]) == float(want)


# --------------------------------------------------------------------------- #
# the launcher                                                                 #
# --------------------------------------------------------------------------- #
_STEP_LINE = re.compile(
    r"^\[train\] step +\d+ loss \d+\.\d{4} gnorm \d+\.\d{3} \(\d+ ms/step\)$")
_DONE_LINE = re.compile(
    r"^\[train\] done: step (\d+), (\d+) restarts, loss \d+\.\d{4} -> "
    r"\d+\.\d{4}, stragglers \d+$")


def _launch(*args):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--reduced", "--device", "cpu", "--batch", "2",
         "--seq", "16", *args], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()


def test_launcher_prints_the_reference_lines(tmp_path):
    lines = _launch("--steps", "5", "--log-every", "2")
    assert len(lines) == 3 and all(_STEP_LINE.match(x) for x in lines), lines
    assert [int(x.split()[2]) for x in lines] == [0, 2, 4]
    report = tmp_path / "r.json"
    lines = _launch("--steps", "6", "--ckpt-dir", str(tmp_path / "ck"),
                    "--ckpt-every", "2", "--inject-failures", "3",
                    "--report", str(report))
    assert len(lines) == 1
    m = _DONE_LINE.match(lines[0])
    assert m and m.groups() == ("6", "1"), lines
    import json
    rep = json.loads(report.read_text())
    assert rep["restored_from"] == [2] and len(rep["losses"]) == 7
    assert len(rep["step_s"]) == 7 and rep["device"] == "cpu"


def test_training_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(CFG, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        data_for(CFG, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "smollm-360m", "--reduced", "--steps", "1"])
