"""Prints, per reduced cell, the port's dry-run counts over the JAX
package's: FLOPs outside the kernels and temporaries (against the
reference's stub pass), collective payload (its real pass); the ratios
``tests/test_torch_dryrun.py`` bounds.  Counts from shapes on the CPU,
not device measurements.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/dryrun_ratios.py
"""
import json
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from test_torch_dryrun import (CELLS, FORWARD, MESH,  # noqa: E402
                               _run_reference)

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402


def main():
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        _run_reference(root, [("real",) + c for c in CELLS]
                       + [("stub",) + c for c in FORWARD])
        dr.get_config = get_reduced
        for arch, shape in CELLS:
            def load(mode):
                with open(root / mode / f"{arch}__{shape}__single.json") as f:
                    return json.load(f)
            real = load("real")
            stub = load("stub") if (arch, shape) in FORWARD else real
            rec = dr.trace_cell(get_reduced(arch), shape, MESH)
            print(json.dumps({
                "cell": f"{arch}:{shape}",
                "flops_outside_kernels": (rec["flops"] - rec["kernel_flops"])
                / stub["flops"],
                "temp": rec["memory_analysis"]["temp_size_in_bytes"]
                / stub["memory_analysis"]["temp_size_in_bytes"],
                "collective_payload":
                    rec["collectives"]["payload_bytes_per_chip"]
                    / real["collectives"]["payload_bytes_per_chip"],
                "against": "stub" if (arch, shape) in FORWARD else "real"}),
                flush=True)


if __name__ == "__main__":
    main()
