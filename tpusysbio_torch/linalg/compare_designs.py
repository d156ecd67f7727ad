"""Two designs of the K1 and K2 kernels on one card, in one process.

Usage, from the root of the repository on a machine with an NVIDIA GPU and
``nvcc``, with another checkout of the repository unpacked at ``DIR`` (for
example ``git archive <commit> | tar -x -C DIR``):

    python3 -m tpusysbio_torch.linalg.compare_designs --other DIR

It builds this tree's ``linalg/csrc`` and the other tree's, loads the other
tree's ``gpu_lu.py`` beside this one (each wrapper launching its own
tree's kernels), and for ``gj_inverse_f32`` (K1) and ``refine_solve`` (K2)
at n = 22 and B = 16, 64, 256, 1024 (and n = 64 at B = 256):

- says whether the two designs' outputs are equal bit for bit;
- times both in turns (other, this, this, other), once queued behind
  ~60 ms of device work (device time) and once at the host's launch pace
  (the wrapper's host time), by CUDA events over 200 launches.

The lines go to standard output and, with ``--out FILE``, the figures to
a JSON file. Two versions are compared only within one process on one
card: another run may land on a card with another power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

from tpusysbio_torch.linalg import _build, gpu_lu
from tpusysbio_torch.linalg.timing import cuda_ms

BATCHES = (16, 64, 256, 1024)
REPS = 200


def _load_other(root: Path):
    """The other tree's wrappers, launching the other tree's kernels."""
    info = _build.compile_library(root / "tpusysbio_torch" / "linalg"
                                  / "csrc")
    lib = _build.open_library(info["path"])
    spec = importlib.util.spec_from_file_location(
        "tpusysbio_torch_other_gpu_lu",
        root / "tpusysbio_torch" / "linalg" / "gpu_lu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(load=lambda: lib)
    mod._LAYOUT = "minor"
    return mod, info


def _report(tag, info):
    print(f"[build] {tag}: {info['seconds']:.2f} s "
          f"(cached={info['cached']})")
    for r in _build.resource_report(info.get("log", "")):
        print(f"[build]   {r['source']} {r['kernel']}: {r['registers']} "
              f"registers, stack {r['stack']} B, spill stores "
              f"{r['spill_stores']} B, loads {r['spill_loads']} B")


def _turns(other_fn, this_fn, queued):
    """other, this, this, other: ms of each turn."""
    o1 = cuda_ms(other_fn, REPS, queued=queued)
    t1 = cuda_ms(this_fn, REPS, queued=queued)
    t2 = cuda_ms(this_fn, REPS, queued=queued)
    o2 = cuda_ms(other_fn, REPS, queued=queued)
    return dict(other=[o1, o2], this=[t1, t2])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--out", help="write the figures to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_designs needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {card}")
    _build.load()
    _report("this tree", _build.build_info)
    other, info = _load_other(Path(args.other).resolve())
    _report(f"other tree ({args.other})", info)
    gpu_lu._LAYOUT = "minor"

    rng = np.random.default_rng(0)
    results = dict(card=card, other=args.other, rows=[])
    for n, batches in ((22, BATCHES), (64, (256,))):
        for B in batches:
            a = torch.as_tensor(
                np.eye(n)[None] - 0.08 * rng.standard_normal((B, n, n)),
                device="cuda")
            b = torch.as_tensor(rng.standard_normal((B, n)), device="cuda")
            a32 = a.to(torch.float32).contiguous()
            x32 = gpu_lu.gj_inverse_f32(a32)
            cases = (
                ("K1 gj_inverse_f32",
                 lambda: other.gj_inverse_f32(a32),
                 lambda: gpu_lu.gj_inverse_f32(a32)),
                ("K2 refine_solve",
                 lambda: other.refine_solve(x32, a, b),
                 lambda: gpu_lu.refine_solve(x32, a, b)))
            for name, other_fn, this_fn in cases:
                equal = bool(torch.equal(other_fn(), this_fn()))
                torch.cuda.synchronize()
                q = _turns(other_fn, this_fn, queued=True)
                h = _turns(other_fn, this_fn, queued=False)
                results["rows"].append(dict(kernel=name, n=n, B=B,
                                            bitwise_equal=equal, queued=q,
                                            host_paced=h))
                print(f"[compare] {name} n={n} B={B}: bitwise equal "
                      f"{equal}; queued ms other "
                      f"{q['other'][0]:.4f}/{q['other'][1]:.4f} this "
                      f"{q['this'][0]:.4f}/{q['this'][1]:.4f}; host-paced "
                      f"ms other {h['other'][0]:.4f}/{h['other'][1]:.4f} "
                      f"this {h['this'][0]:.4f}/{h['this'][1]:.4f}",
                      flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    print(card)


if __name__ == "__main__":
    main()
