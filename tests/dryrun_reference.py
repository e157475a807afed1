"""The JAX package's dry run on reduced configs, for the port's dry-run
tests (``tests/test_torch_dryrun.py``, ``tests/test_torch_roofline.py``).

Run as a process, never imported by a test process: importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 devices, and this
script sets 8 before JAX starts.

    python tests/dryrun_reference.py OUT_DIR real|stub|specs:arch:shape ...

For each cell it writes ``OUT_DIR/<mode>/<arch>__<shape>__single.json`` (the
reference's record), ``.hlo`` (the compiled full-depth program's text)
and ``.specs.json`` (the flattened argument indices ``jax.jit`` kept, the
model FLOPs, the preset, the batch shapes and the input specs' shapes),
from ``repro.launch.dryrun.run_cell`` with two changes, and a third
under ``stub``; under ``specs`` it writes only
``OUT_DIR/specs/<arch>__<shape>.specs.json``, the shapes and dtypes of
``input_specs_for(cfg, shape_name=shape)``, and runs no cell:

* the reduced config (``repro.configs.get_reduced``) in place of the
  full one;
* a (2, 4) ("data", "model") mesh of 8 CPU devices whose axes are
  ``Auto``: jax 0.9.0's ``jax.make_mesh`` makes ``Explicit`` axes, on
  which the reference's SP and EP hints raise (``ValueError: ... can only
  refer to Auto axes``);
* (``stub``) the reference's kernels (``kops.flash_attention``, ``flash_decode``,
  ``wkv6``, ``linear_recurrence``, and the oracles cross-attention calls
  directly) replaced by stand-ins of the same shapes and dependencies that
  cost a few elementwise adds.  The reference lowers its kernels' jnp
  oracles, whose loops (``lax.map`` over query chunks, ``lax.scan`` over
  time) XLA's cost analysis counts once, and whose score chunks fill its
  temporaries; the port counts what its kernels do.  With the stand-ins
  both sides count the step outside the kernels, which the tests compare.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
import repro.launch.dryrun as dr  # noqa: E402  (sets XLA_FLAGS; reset below)

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_reduced  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.launch import mesh as meshmod  # noqa: E402
from repro.models import blocks  # noqa: E402


def _attention(q, k, v, *args, **kwargs):
    G = q.shape[2] // k.shape[2]
    hdv = v.shape[-1]
    kv = k[..., :hdv].astype(v.dtype) + v
    if kv.shape[1] != q.shape[1]:            # cross-attention: frames
        kv = jnp.sum(kv, axis=1, keepdims=True)
    return q[..., :hdv] + jnp.repeat(kv, G, axis=2).astype(q.dtype)


def _decode(q, k_cache, v_cache, cur_len, *args, **kwargs):
    G = q.shape[1] // k_cache.shape[2]
    hdv = v_cache.shape[-1]
    kv = k_cache[:, 0, :, :hdv].astype(v_cache.dtype) + v_cache[:, 0]
    return q[..., :hdv] + jnp.repeat(kv, G, axis=1).astype(q.dtype)


def _wkv6(r, k, v, w, u, s0):
    dv = v.shape[-1]
    f32 = jnp.float32
    y = ((r + k).astype(f32) + w.astype(f32))[..., :dv] + v.astype(f32)
    sT = s0 + (k[:, -1, :, :, None] * v[:, -1, :, None, :]).astype(f32)
    return y, sT


def _recurrence(a, b, h0):
    h = a.astype(jnp.float32) + b.astype(jnp.float32) + h0[:, None]
    return h, h[:, -1]


_STUBS = ((kops, "flash_attention", _attention), (kops, "flash_decode", _decode),
          (kops, "wkv6", _wkv6), (kops, "linear_recurrence", _recurrence),
          (blocks, "chunked_attention", _attention),
          (blocks, "decode_attention", _decode))
_KERNELS = [(mod, name, getattr(mod, name)) for mod, name, _ in _STUBS]


def _use(mode):
    if mode not in ("real", "stub"):
        raise SystemExit(f"mode {mode!r}: 'real', 'stub' or 'specs'")
    for mod, name, fn in (_STUBS if mode == "stub" else _KERNELS):
        setattr(mod, name, fn)


def main(out_root, jobs):
    dr.get_config = get_reduced
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    meshmod.make_production_mesh = lambda multi_pod=False: mesh
    first = {}
    compile_ = jax.stages.Lowered.compile

    def keep_text(self, *a, **kw):
        c = compile_(self, *a, **kw)
        if "text" not in first:           # the full-depth program
            first["text"] = c.as_text()
            first["kept"] = sorted(self._lowering.compile_args["kept_var_idx"])
        return c
    jax.stages.Lowered.compile = keep_text
    for job in jobs:
        mode, arch, shape = job.split(":")
        if mode == "specs":
            _write_input_specs(out_root, arch, shape)
            print(f"{job} ok", flush=True)
            continue
        _use(mode)
        out_dir = os.path.join(out_root, mode)
        first.clear()
        dr.run_cell(arch, shape, False, out_dir=out_dir, verbose=False)
        stem = os.path.join(out_dir, f"{arch}__{shape}__single")
        with open(stem + ".hlo", "w") as f:
            f.write(first["text"])
        cfg, sh = get_reduced(arch), dr.SHAPES[shape]
        specs = dr.input_specs_for(
            cfg, shape, dtype=jnp.bfloat16,
            factored=dr.auto_factored(cfg))
        with open(stem + ".specs.json", "w") as f:
            json.dump({
                "kept": first["kept"],
                "model_flops": dr.model_flops(cfg, sh),
                "preset": {k: str(v) for k, v in dr.preset(arch,
                                                           shape).items()},
                "batch_shapes": {
                    k: [list(v.shape), str(v.dtype)] for k, v in
                    dr.batch_shapes(cfg, sh.global_batch,
                                    sh.seq_len).items()},
                "input_specs": [[list(x.shape), str(x.dtype)]
                                for x in jax.tree.leaves(specs)]}, f)
        print(f"{job} ok", flush=True)


def _write_input_specs(out_root, arch, shape):
    cfg = get_reduced(arch)
    specs = dr.input_specs_for(cfg, shape_name=shape, dtype=jnp.bfloat16,
                               factored=dr.auto_factored(cfg))
    out_dir = os.path.join(out_root, "specs")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape}.specs.json"), "w") as f:
        json.dump({"input_specs": [[list(x.shape), str(x.dtype)]
                                   for x in jax.tree.leaves(specs)]}, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
