"""Distributed pencil-FFT demo: the multi-device FFT path on
``torch.distributed`` ranks, validated against numpy; the reference's
``examples/distributed_fft_demo.py`` on the port.

On the card (the default) it runs one ``nccl`` rank a visible card, on the
reference's axis names at the sizes the ranks allow: one H100 gives the
meshes (1, 1) and (1,).  ``--device cpu`` runs 8 ``gloo`` ranks with the
reference's meshes (2, 4) and (8,).  The ranks join through a ``file://``
store in a temporary directory (no TCP port); one rank runs in this
process, more are spawned.

  PYTHONPATH=src python examples/torch_distributed_fft_demo.py
  PYTHONPATH=src python examples/torch_distributed_fft_demo.py --device cpu

``--report PATH`` writes rank 0's numbers as JSON: the errors against
numpy, the split, the Suite run's validate rows and forward times, and the
launches of each hand-written kernel on rank 0.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.client import TorchContext
from repro_torch.core.suite import Session, SuiteSpec
from repro_torch.fft import distributed as dfft
from repro_torch.launch.mesh import exit_rank, make_mesh

SHAPE = (32, 16, 64)
N1D = 1 << 14
#: gloo ranks of a ``--device cpu`` run: the reference's 8 fake devices
CPU_RANKS = 8
#: the kernels whose launches the report counts (``kernels/<name>/ops``)
KERNELS = ("stockham_pallas", "fft2_pallas", "fft4step", "dft_matmul",
           "fftconv")


def mesh_2d(p: int) -> tuple[int, int]:
    """The most balanced (rows, cols) of ``p`` ranks with rows <= cols:
    (2, 4) for 8, as the reference's, (1, 1) for one."""
    rows = max(d for d in range(1, p + 1) if p % d == 0 and d * d <= p)
    return rows, p // rows


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _launches() -> dict:
    import importlib
    out = {}
    for name in KERNELS:
        ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
        out[name] = {"count": ops.LAUNCHES,
                     "shapes": [[list(k), c]
                                for k, c in ops.LAUNCH_SHAPES.items()]}
    return out


def run(device: torch.device, say) -> dict:
    """Every rank's part of the demo; returns the numbers (rank 0 holds
    the same as every other)."""
    p = dist.get_world_size()
    mesh = make_mesh(mesh_2d(p), ("data", "model"))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)
         ).astype(np.complex64)
    fft3d, in_spec, out_spec = dfft.make_fft3d(mesh, "data", "model", SHAPE)
    xb = torch.from_numpy(np.ascontiguousarray(
        dfft.shard(x, mesh, in_spec))).to(device)
    y = dfft.unshard(fft3d(xb), mesh, out_spec).cpu().numpy()
    want = np.fft.fftn(x)
    out = {"ranks": p, "backend": dist.get_backend(),
           "mesh3d": list(mesh.ranks.shape),
           "fft3d": {"max_abs_err": float(np.abs(y - want).max()),
                     "rel_l2": rel_l2(y, want)}}
    say(f"3D pencil FFT {SHAPE} on mesh {dict(mesh.shape)}: "
        f"max |err| = {out['fft3d']['max_abs_err']:.2e} "
        f"(rel-L2 {out['fft3d']['rel_l2']:.2e})")
    say(f"per-device shards: {dfft.block_shape(SHAPE, mesh, in_spec)}")

    n = N1D
    x1 = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64)
    mesh1 = make_mesh((p,), ("data",))
    fft1d, (n1, n2) = dfft.make_fft1d(mesh1, "data", n, device=device)
    x1b = torch.from_numpy(np.ascontiguousarray(
        dfft.shard(x1, mesh1, ("data",)))).to(device)
    y1b = fft1d(x1b)
    y1 = dfft.unshard(y1b, mesh1, ("data",)).cpu().numpy()
    nat = dfft.transposed_to_natural(y1, n1, n2)
    ref = np.fft.fft(x1)
    out["fft1d"] = {"n1": n1, "n2": n2,
                    "rel_err": float(np.abs(nat - ref).max()
                                     / np.abs(ref).max()),
                    "rel_l2": rel_l2(nat, ref)}
    say(f"1D distributed four-step n={n} (n1={n1}, n2={n2}): rel err = "
        f"{out['fft1d']['rel_err']:.2e} (transposed-out layout; rel-L2 "
        f"{out['fft1d']['rel_l2']:.2e})")

    # transposed-in inverse: round trip without any reordering pass
    ifft1d, _ = dfft.make_ifft1d(mesh1, "data", n, device=device)
    xr = dfft.unshard(ifft1d(y1b), mesh1, ("data",)).cpu().numpy()
    out["ifft1d"] = {"max_abs_err": float(np.abs(xr - x1).max()),
                     "rel_l2": rel_l2(xr, x1)}
    say(f"1D inverse (TRANSPOSED_IN): roundtrip err = "
        f"{out['ifft1d']['max_abs_err']:.2e} (rel-L2 "
        f"{out['ifft1d']['rel_l2']:.2e})")

    # the same path measured through the declarative Suite API
    spec = SuiteSpec(clients=("TorchDistFFT1D",), extents=("4096",),
                     kinds=("Outplace_Complex",), precisions=("float",),
                     warmups=1, repetitions=3, output=None,
                     verbose=dist.get_rank() == 0)
    results = Session(TorchContext(device.type)).run(spec)
    out["suite"] = {"validate": [[r.success, r.error] for r in results.rows
                                 if r.op == "validate"],
                    "n_failures": results.n_failures,
                    "execute_forward_ms": []}
    for (lib, ext, prec, kind, rigor, op, mean, sd, cnt) in \
            results.aggregate(op="execute_forward"):
        out["suite"]["execute_forward_ms"].append(mean)
        say(f"{lib} n={ext} on {p} ranks: execute_forward "
            f"{mean*1e3:.1f} us (n={cnt})")
    stats = results.plan_stats
    say(f"plan cache: {stats.hits} hits, {stats.misses} misses")
    out["launches"] = _launches()
    return out


def _rank(rank: int, world: int, device_type: str, store: str,
          report: str | None) -> None:
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                device_id=device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
    say = (lambda s: print(s, flush=True)) if rank == 0 else \
        (lambda s: None)
    try:
        out = run(device, say)
        if rank == 0 and report:
            with open(report, "w") as f:
                json.dump(out, f, indent=1)
    finally:
        dist.destroy_process_group()


def _spawned(rank: int, world: int, device_type: str, store: str,
             report: str | None) -> None:
    _rank(rank, world, device_type, store, report)
    exit_rank()     # a gloo rank can abort in the interpreter's teardown


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): one nccl rank a visible card; "
                         f"cpu: {CPU_RANKS} gloo ranks")
    ap.add_argument("--report", default=None,
                    help="write rank 0's numbers to this JSON file")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA GPU found (pass --device cpu to run "
                               f"{CPU_RANKS} gloo ranks on the CPU)")
        world = torch.cuda.device_count()
    else:
        world = CPU_RANKS
    with tempfile.TemporaryDirectory(prefix="dist_fft_demo_") as td:
        store = os.path.join(td, "store")
        if world == 1:
            _rank(0, 1, args.device, store, args.report)
        else:
            import torch.multiprocessing as mp
            mp.spawn(_spawned, args=(world, args.device, store, args.report),
                     nprocs=world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
