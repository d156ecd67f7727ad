"""Two designs of the K1, K2 and K3 kernels on one card, in one process.

Usage, from the root of the repository on a machine with an NVIDIA GPU and
``nvcc``, with another checkout of the repository unpacked at ``DIR`` (for
example ``git archive <commit> | tar -x -C DIR``):

    python3 -m tpusysbio_torch.linalg.compare_designs --other DIR

It builds this tree's ``linalg/csrc`` and the other tree's, loads the other
tree's ``gpu_lu.py`` beside this one (each wrapper launching its own
tree's kernels), and for ``gj_inverse_f32`` under the ``minor`` layout
(K1), under the ``major`` layout (K3) and ``refine_solve`` (K2) at n = 22
and B = 16, 64, 256, 1024 (and n = 64 at B = 256); for K3 also at
B = 4096 and at the block-Schur shapes of a 99-state model, (64, 64, 64)
and (64, 35, 35):

- says whether the two designs' outputs are equal bit for bit, and for K3
  also whether this tree's K3 equals this tree's K1;
- times both in turns (other, this, this, other), once queued behind
  ~60 ms of device work (device time) and once at the host's launch pace
  (the wrapper's host time), by CUDA events over 200 launches; K3's rows
  carry this tree's K1 at the same shape, timed in the same turn.

Before the timed shapes it holds the three Gauss-Jordan designs (the other
tree's K3, this tree's K3, this tree's K1) against each other bit for bit
on the shapes where the designs differ: n = 1, 8, 9, 32, 33, 40, 41, 64,
batches that do not fill K3's last warp, general matrices that exchange
rows at most steps, tied pivots, a singular and a NaN member.

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
    linalg = root / "tpusysbio_torch" / "linalg"
    info = _build.compile_library(linalg / "csrc")
    lib = _build.open_library(info["path"])
    mod, seam = None, None
    for name in ("kernels", "gpu_lu"):   # a tree may predate kernels.py
        if (linalg / f"{name}.py").exists():
            spec = importlib.util.spec_from_file_location(
                f"tpusysbio_torch_other_{name}", linalg / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            seam = seam or mod   # the module that loads the library
    seam._build = types.SimpleNamespace(load=lambda: lib)
    mod.kernels = seam
    return mod, info


def _report(tag, info):
    print(f"[build] {tag}: {info['seconds']:.2f} s "
          f"(cached={info['cached']})")
    for r in _build.resource_report(info.get("log", "")):
        print(f"[build]   {r['source']} {r['kernel']}: {r['registers']} "
              f"registers, stack {r['stack']} B, spill stores "
              f"{r['spill_stores']} B, loads {r['spill_loads']} B")


def _turns(other_fn, this_fn, queued, beside=None):
    """other, this, this, other: ms of each turn; ``beside`` (a third
    callable) is timed once between the two turns of ``this``."""
    o1 = cuda_ms(other_fn, REPS, queued=queued)
    t1 = cuda_ms(this_fn, REPS, queued=queued)
    extra = {} if beside is None else dict(
        beside=cuda_ms(beside, REPS, queued=queued))
    t2 = cuda_ms(this_fn, REPS, queued=queued)
    o2 = cuda_ms(other_fn, REPS, queued=queued)
    return dict(other=[o1, o2], this=[t1, t2], **extra)


def _gj(mod, layout):
    """``mod.gj_inverse_f32`` under ``layout``: 'minor' launches the tree's
    K1, 'major' its K3."""
    def call(a):
        mod._LAYOUT = layout
        return mod.gj_inverse_f32(a)

    return call


def _same_bits(x, y) -> bool:
    """Equal bit for bit, a NaN counting as equal to a NaN."""
    bits = torch.int32 if x.element_size() == 4 else torch.int64
    same = x.view(bits) == y.view(bits)
    return bool((same | (x.isnan() & y.isnan())).all())


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32, device="cuda").contiguous()


def _newton(rng, B, n):
    return np.eye(n)[None] - 0.08 * rng.standard_normal((B, n, n))


def _equality_cases(rng):
    """(name, (B, n, n) f32) for the bitwise comparison of the designs."""
    for n in (1, 8, 9, 22, 32, 33, 40, 41, 64):
        for B in (1, 7, 33):
            yield f"newton n={n} B={B}", _f32(_newton(rng, B, n))
    for n in (5, 22, 35, 64):
        yield (f"general n={n} B=67",
               _f32(rng.standard_normal((67, n, n))))
    yield "tied pivots", _f32(
        [[[2.0, 1.0, 0.0], [-2.0, 3.0, 1.0], [2.0, 0.0, 5.0]],
         [[0.0, 1.0, 2.0], [1.0, 1.0, 0.0], [-1.0, 1.0, 3.0]]])
    yield "singular", _f32([[[1.0, 2.0], [2.0, 4.0]],
                            [[0.0, 0.0], [0.0, 0.0]]])
    nan = _newton(rng, 6, 22)
    nan[3, 4, 5] = np.nan
    yield "a NaN member among 6, n=22", _f32(nan)


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
    results = dict(card=card, other=args.other, equality=[], rows=[])
    k1, k3 = _gj(gpu_lu, "minor"), _gj(gpu_lu, "major")
    other_k1, other_k3 = _gj(other, "minor"), _gj(other, "major")

    for name, a32 in _equality_cases(rng):
        new, old, reg = k3(a32), other_k3(a32), k1(a32)
        torch.cuda.synchronize()
        row = dict(case=name, k3_equals_other_k3=_same_bits(new, old),
                   k3_equals_k1=_same_bits(new, reg))
        results["equality"].append(row)
        print(f"[equal] {name}: K3 = other K3 "
              f"{row['k3_equals_other_k3']}, K3 = K1 {row['k3_equals_k1']}",
              flush=True)

    def compare(name, n, B, other_fn, this_fn, beside=None):
        got = this_fn()
        row = dict(kernel=name, n=n, B=B,
                   bitwise_equal=_same_bits(other_fn(), got))
        if beside is not None:
            row["equals_k1"] = _same_bits(beside(), got)
        torch.cuda.synchronize()
        q = _turns(other_fn, this_fn, True, beside)
        h = _turns(other_fn, this_fn, False, beside)
        row.update(queued=q, host_paced=h)
        results["rows"].append(row)
        k1_note = ("" if beside is None else
                   f"; this tree's K1 queued {q['beside']:.4f}, host-paced "
                   f"{h['beside']:.4f}, K3 = K1 {row['equals_k1']}")
        print(f"[compare] {name} n={n} B={B}: bitwise equal "
              f"{row['bitwise_equal']}; queued ms other "
              f"{q['other'][0]:.4f}/{q['other'][1]:.4f} this "
              f"{q['this'][0]:.4f}/{q['this'][1]:.4f}; host-paced "
              f"ms other {h['other'][0]:.4f}/{h['other'][1]:.4f} "
              f"this {h['this'][0]:.4f}/{h['this'][1]:.4f}{k1_note}",
              flush=True)

    for n, batches in ((22, BATCHES), (64, (256,))):
        for B in batches:
            a = torch.as_tensor(_newton(rng, B, n), device="cuda")
            b = torch.as_tensor(rng.standard_normal((B, n)), device="cuda")
            a32 = a.to(torch.float32).contiguous()
            x32 = k1(a32)
            compare("K1 gj_inverse_f32", n, B, lambda: other_k1(a32),
                    lambda: k1(a32))
            compare("K2 refine_solve", n, B,
                    lambda: other.refine_solve(x32, a, b),
                    lambda: gpu_lu.refine_solve(x32, a, b))
    for n, batches in ((22, BATCHES + (4096,)), (64, (64, 256)),
                       (35, (64,))):
        for B in batches:
            a32 = _f32(_newton(rng, B, n))
            compare("K3 gj_inverse_major_f32", n, B, lambda: other_k3(a32),
                    lambda: k3(a32), beside=lambda: k1(a32))
    gpu_lu._LAYOUT = "minor"
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    print(card)


if __name__ == "__main__":
    main()
