"""Production-mesh dry run: trace one step of every (arch x shape) on the
reference's meshes and record its per-device memory, flops and
collectives for the roofline report.

The reference package's ``launch/dryrun.py``, flag for flag.  The
reference lowers and compiles for 256 or 512 fake XLA devices; here the
process joins a ``"fake"`` process group of 256 or 512 ranks (it is rank
0, and every collective returns at once) and runs the step eagerly on
``meta`` tensors: the parameters, optimizer state, batch and cache are
DTensors laid out as a real run would lay them out, with no storage.  The
fake group becomes the process's default group, so a dry run runs in a
process of its own (``python -m repro_torch.launch.dryrun``; a caller
spawns it).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
One JSON per cell under ``build/dryrun/`` (``--out-dir``).  A record has
the reference's keys: ``arch``, ``shape``, ``mesh`` (``16x16`` or
``2x16x16``), ``status``, ``mode``, ``opt_level``, ``lower_s`` (the
trace's seconds), ``memory.argument_size_in_bytes`` (this rank's shards of
the parameters, the optimizer state or cache, and the batch, counted
exactly), ``flops_per_device``, ``dot_bytes_per_device`` and
``collectives`` (``roofline/op_count.py``).  The reference's
``temp_size_in_bytes`` (XLA's buffer assignment) has no counterpart here
and is left out; ``compile_s`` likewise.

``--reduced`` traces the smoke-size config instead, and ``--mesh DxM``
another layout (``data`` x ``model``; three numbers add ``pod``), for
tests on a few fake ranks.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import (SHAPES, get_config, input_specs,
                                      list_configs, shape_supported)
from repro_torch.launch.mesh import dp_axes, make_mesh, make_production_mesh
from repro_torch.models.convert import named_tensors
from repro_torch.models.model import Model
from repro_torch.roofline.op_count import OpCounter
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import build_train_step

OUT_DIR = os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "../../../build/dryrun"))


def join_fake_group(world: int) -> None:
    """Make this process rank 0 of a ``"fake"`` process group of
    ``world`` ranks (no group may exist yet)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks exists; the dry run needs {world}")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(t: torch.Tensor) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return _local_bytes(tree)


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.ranks.shape)


def _mesh_of(multi_pod: bool, shape: str | None):
    if shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    dims = tuple(int(v) for v in shape.split("x"))
    axes = ("data", "model")[:len(dims)] if len(dims) <= 2 \
        else ("pod", "data", "model")
    return make_mesh(dims, axes)


def lower_cell(arch: str, shape: str, multi_pod: bool,
               opt_level: str = "tuned", reduced: bool = False,
               mesh_shape: str | None = None) -> dict:
    """Trace one cell.  Returns its record."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    mesh = _mesh_of(multi_pod, mesh_shape)
    name = _mesh_name(mesh)
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": name, "status": why}
    sp = SHAPES[shape]
    if reduced:
        sp = type(sp)(sp.name, min(sp.seq_len, 64),
                      min(sp.global_batch, 8), sp.mode)
    join_fake_group(mesh.size)
    model = Model(cfg, mesh=mesh, device="meta", remat=True)
    dp = math.prod(mesh.shape[a] for a in dp_axes(mesh))

    t0 = time.perf_counter()
    params = model.shard(model.abstract_params())
    specs = _input_specs(cfg, sp)
    args_bytes = _tree_bytes(named_tensors(params))
    counter = OpCounter()
    with counter:
        if sp.mode == "train":
            opt_state = init_opt_state(params)
            micro = 1
            if opt_level != "paper":
                micro = 16 if cfg.block_kind == "vlm" else 4
                # each microbatch must still shard over dp
                micro = min(micro, max(1, sp.global_batch // dp))
            step = build_train_step(model, OptConfig(), microbatches=micro)
            batch = dict(specs)
            args_bytes += _tree_bytes(opt_state["m"]) + \
                _tree_bytes(opt_state["v"]) + 4
            args_bytes += sum(_local_bytes(model.sh.batch(v))
                              for v in batch.values())
            step(params, opt_state, batch)
        else:
            cache = model.init_cache(sp.global_batch, sp.seq_len)
            args_bytes += _tree_bytes(cache)
            tokens = specs["tokens"]
            image = specs.get("image_embeds")
            args_bytes += _local_bytes(model.sh.batch(tokens))
            if image is not None:
                args_bytes += _local_bytes(model.sh.batch(image))
            with torch.no_grad():
                if sp.mode == "prefill":
                    model.prefill(params, tokens, cache, image_embeds=image)
                else:
                    args_bytes += 4  # pos
                    model.decode_step(params, tokens, cache,
                                      sp.seq_len - 1, image_embeds=image)
    t_lower = time.perf_counter() - t0
    hlo = counter.summary()
    return {
        "arch": arch, "shape": shape, "mesh": name,
        "status": "ok",
        "mode": sp.mode,
        "opt_level": opt_level,
        "lower_s": round(t_lower, 2),
        "memory": {"argument_size_in_bytes": int(args_bytes)},
        "flops_per_device": hlo["dot_flops"],
        "dot_bytes_per_device": hlo["dot_bytes"],
        "collectives": {"total_bytes": hlo["collective_total"],
                        "by_kind": hlo["collective_bytes"],
                        "counts": hlo["collective_counts"],
                        "by_axis": hlo["collective_by_axis"]},
    }


def _input_specs(cfg, sp) -> dict:
    """``input_specs`` at a (possibly cut) shape: meta stand-ins."""
    specs = input_specs(cfg, sp.name)
    if specs["tokens"].shape[0] == sp.global_batch and (
            sp.mode == "decode" or specs["tokens"].shape[1] == sp.seq_len):
        return specs
    b, s = sp.global_batch, sp.seq_len if sp.mode != "decode" else 1
    out = {"tokens": torch.empty((b, s, cfg.n_codebooks) if cfg.n_codebooks
                                 else (b, s), dtype=torch.int32,
                                 device="meta")}
    if "image_embeds" in specs:
        out["image_embeds"] = torch.empty(
            (b, cfg.n_image_tokens, cfg.d_model), dtype=cfg.dtype,
            device="meta")
    return out


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             opt_level: str = "tuned", reduced: bool = False,
             mesh_shape: str | None = None) -> dict:
    try:
        record = lower_cell(arch, shape, multi_pod, opt_level, reduced,
                            mesh_shape)
    except Exception as e:
        record = {"arch": arch, "shape": shape,
                  "mesh": mesh_shape or ("2x16x16" if multi_pod else "16x16"),
                  "status": f"ERROR: {type(e).__name__}: {e}",
                  "trace": traceback.format_exc()[-2000:]}
    os.makedirs(OUT_DIR, exist_ok=True)
    tag = f"{arch}_{shape}_{record['mesh'].replace('x', '-')}.json"
    with open(os.path.join(OUT_DIR, tag), "w") as f:
        json.dump(record, f, indent=1)
    if verbose:
        st = record["status"]
        extra = ""
        if st == "ok":
            mem_gb = record["memory"]["argument_size_in_bytes"] / 2**30
            extra = (f" trace={record['lower_s']:.1f}s "
                     f"args/dev={mem_gb:.2f}GiB "
                     f"flops/dev={record['flops_per_device']:.3g} "
                     f"coll/dev={record['collectives']['total_bytes']/2**20:.0f}MiB")
        print(f"[dryrun] {arch} x {shape} x {record['mesh']}: {st}{extra}",
              flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt-level", default="tuned", choices=["paper", "tuned"])
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="trace the smoke-size config (tests)")
    ap.add_argument("--mesh", default=None,
                    help="another mesh than the production ones, e.g. 2x2")
    ap.add_argument("--one-mesh", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    global OUT_DIR
    if args.out_dir:
        OUT_DIR = os.path.abspath(args.out_dir)

    archs = list_configs() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = [False, True] if (args.both_meshes or
                               (args.all and not args.multi_pod)) \
        else [args.multi_pod]
    if args.mesh or args.one_mesh:
        meshes = [args.multi_pod and not args.mesh]
    if len(meshes) > 1:
        # one fake group a process: each mesh runs in a child of its own
        import subprocess
        rc = 0
        for mp in meshes:
            child = [a for a in (argv if argv is not None else sys.argv[1:])
                     if a not in ("--both-meshes", "--multi-pod")]
            child.append("--one-mesh")
            if mp:
                child.append("--multi-pod")
            rc |= subprocess.call([sys.executable, "-m",
                                   "repro_torch.launch.dryrun", *child])
        return rc

    n_bad = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mp, opt_level=args.opt_level,
                               reduced=args.reduced, mesh_shape=args.mesh)
                if str(rec["status"]).startswith("ERROR"):
                    n_bad += 1
    print(f"[dryrun] done, {n_bad} failures")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
