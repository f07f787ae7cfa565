"""Roofline models: the FFT's modeled flops, per-device peaks and the
achieved fraction of whichever wall binds; the LM workloads' parameter
and flop counts.

The reference package's ``roofline/analysis.py`` FFT part, with the
H100's envelope in place of the TPUs'.  The H100 entry is the SXM data
sheet's dense float32 rate outside the tensor cores and its HBM3 rate, the
same peaks ``chip_smoke.py`` bounds every kernel by.

Also the reference's LM formulas: ``active_params`` (parameters a token
uses, embeddings excluded) and ``model_flops`` (6·N·D for a training
step, 2·N·D for inference), for every block kind.

And the report half: dry-run records (``launch/dryrun.py``) -> the
three-term roofline table.  Terms, in seconds per device (the records'
counts are per device already):

  compute    = flops_per_device / PEAK_FLOPS
  memory     = dot_bytes_per_device / HBM_BW   (the products' operand and
               output traffic: an upper bound on HBM movement)
  collective = collectives.total_bytes / COLL_BW

The constants are the H100 SXM's, never the reference's TPU v5e figures:
989e12 dense bf16 flop/s (tensor cores, no sparsity) and 3.35e12 B/s
HBM3, from NVIDIA's H100 data sheet.  A 16-rank axis of the production
meshes spans two 8-GPU nodes, so its collectives run at the inter-node
rate, not NVLink's: COLL_BW is one NDR InfiniBand port per GPU, 400 Gb/s =
50e9 B/s (the DGX H100's eight ConnectX-7 ports, one a GPU).

    PYTHONPATH=src python -m repro_torch.roofline.analysis --dir build/dryrun
"""

from __future__ import annotations

import glob
import json
import math
import os
from dataclasses import dataclass

from repro_torch.configs.base import SHAPES, get_config

#: Per-device (peak FLOP/s, HBM bytes/s) envelopes for the FFT roofline,
#: keyed by a lowercase prefix of the device kind
#: (``torch.cuda.get_device_name``, or ``"cpu"``).  The ``cpu`` entry is
#: the reference's deliberately conservative host envelope, so a CPU run
#: still gives finite fractions; they compare only on one host.
DEVICE_PEAKS = {
    "cpu": (5.0e10, 2.0e10),
    "nvidia h100": (67e12, 3.35e12),
}


def device_peaks(device_kind: str | None) -> tuple[float, float]:
    """(peak FLOP/s, HBM bytes/s) for a device kind, by longest lowercase
    prefix match; an unknown kind falls back to the cpu envelope."""
    dk = (device_kind or "").lower()
    best = None
    for prefix, peaks in DEVICE_PEAKS.items():
        if dk.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), peaks)
    return best[1] if best else DEVICE_PEAKS["cpu"]


def fft_model_flops(extents, batch: int = 1) -> float:
    """Modeled FFT flops: 5·N·log2(N) over the full nd problem (the log2
    factors of the axes sum, so the total-N form covers any rank) times the
    batch."""
    n = 1
    for e in extents:
        n *= int(e)
    if n <= 1:
        return 0.0
    return 5.0 * batch * n * math.log2(n)


def fft_roofline_frac(time_ms: float, flops: float, bytes_moved: float,
                      device_kind: str | None) -> float:
    """Achieved fraction of the modeled roofline for one measured FFT:
    ``max(flops / peak_flops, bytes / hbm_bw)`` over the measured time.
    Finite for a positive measurement: a non-finite or non-positive bytes
    model contributes nothing to the ideal."""
    if not time_ms or time_ms <= 0.0:
        return 0.0
    peak_flops, hbm_bw = device_peaks(device_kind)
    terms = [0.0]
    if flops and flops > 0 and flops != float("inf"):
        terms.append(flops / peak_flops)
    if bytes_moved and bytes_moved > 0 and bytes_moved != float("inf"):
        terms.append(bytes_moved / hbm_bw)
    return max(terms) / (time_ms * 1e-3)


def active_params(cfg) -> tuple[float, float]:
    """(total_params, active_params) excluding embeddings (6ND convention)."""
    d = cfg.d_model
    kind = cfg.block_kind

    def attn_p():
        if cfg.kv_lora_rank:
            hd = cfg.qk_nope_dim + cfg.qk_rope_dim
            return (d * cfg.n_heads * hd + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                    + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                    + cfg.n_heads * cfg.v_head_dim * d)
        return (d * cfg.n_heads * cfg.head_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim
                + cfg.n_heads * cfg.head_dim * d)

    def mlp_p(dff):
        return (3 if cfg.mlp_gated else 2) * d * dff

    total = active = 0.0
    if kind in ("gqa", "gemma", "musicgen"):
        per = attn_p() + mlp_p(cfg.d_ff)
        total = active = cfg.n_layers * per
    elif kind == "gqa_moe":
        ex = 3 * d * cfg.d_ff_expert
        per_t = attn_p() + cfg.n_experts * ex
        per_a = attn_p() + cfg.top_k * ex
        total, active = cfg.n_layers * per_t, cfg.n_layers * per_a
    elif kind == "mla_moe":
        ex = 3 * d * cfg.d_ff_expert
        shared = 3 * d * cfg.d_ff_expert * max(cfg.n_shared_experts, 1)
        nd_ = cfg.first_dense_layers
        nm = cfg.n_layers - nd_
        total = nd_ * (attn_p() + mlp_p(cfg.d_ff_dense)) + \
            nm * (attn_p() + cfg.n_experts * ex + shared)
        active = nd_ * (attn_p() + mlp_p(cfg.d_ff_dense)) + \
            nm * (attn_p() + cfg.top_k * ex + shared)
    elif kind == "vlm":
        def cross_attn_p():
            # q/out over d, k/v from image embeds of width d
            return (d * cfg.n_heads * cfg.head_dim
                    + 2 * d * cfg.n_kv_heads * cfg.head_dim
                    + cfg.n_heads * cfg.head_dim * d)
        # every cross_every-th decoder layer is cross-attention
        n_cross = cfg.n_layers // cfg.cross_every if cfg.cross_every else 0
        n_self = cfg.n_layers - n_cross
        per_self = attn_p() + mlp_p(cfg.d_ff)
        per_cross = cross_attn_p() + mlp_p(cfg.d_ff)
        total = active = n_self * per_self + n_cross * per_cross
    elif kind == "xlstm":
        di = 2 * d
        per_m = 2 * d * di + 3 * di * di + di * d + 2 * di
        per_s = 4 * d * d + 4 * d * (d // cfg.n_heads) + 2 * d * int(d * 4 / 3)
        total = active = (cfg.n_layers // 2) * (per_m + per_s)
    elif kind == "hymba":
        di = cfg.d_inner
        mamba = 2 * d * di + di * (2 * cfg.ssm_state) + di * max(1, d // 16) * 2 + di * d
        per = attn_p() + mamba + mlp_p(cfg.d_ff)
        total = active = cfg.n_layers * per
    return total, active


def model_flops(arch: str, shape: str) -> float:
    """6*N_active*D for train (fwd+bwd); 2*N_active*D for inference steps."""
    cfg = get_config(arch)
    sp = SHAPES[shape]
    _, act = active_params(cfg)
    if sp.mode == "train":
        return 6.0 * act * sp.global_batch * sp.seq_len
    if sp.mode == "prefill":
        return 2.0 * act * sp.global_batch * sp.seq_len
    return 2.0 * act * sp.global_batch  # one new token per sequence


# --------------------------------------------------------------------------
# the report: dry-run records -> the roofline table
# --------------------------------------------------------------------------
#: H100 SXM dense bf16 tensor-core flop/s (data sheet, without sparsity)
PEAK_FLOPS = 989e12
#: H100 SXM HBM3 bytes/s
HBM_BW = 3.35e12
#: one NDR InfiniBand port a GPU (400 Gb/s): a 16-rank axis spans nodes
COLL_BW = 50e9
CHIPS = {"16x16": 256, "2x16x16": 512}


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = "-"
    model_flops: float = 0.0
    hlo_flops: float = 0.0
    useful_ratio: float = 0.0
    roofline_fraction: float = 0.0
    lower_s: float = 0.0

    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def row_from_record(rec: dict) -> RooflineRow:
    row = RooflineRow(rec["arch"], rec["shape"], rec["mesh"],
                      str(rec["status"]))
    if rec["status"] != "ok":
        return row
    chips = CHIPS.get(rec["mesh"])
    if chips is None:
        # an unfamiliar dry-run mesh is a skipped row, not a crash
        row.status = f"skipped: unknown mesh {rec['mesh']}"
        return row
    row.compute_s = rec["flops_per_device"] / PEAK_FLOPS
    row.memory_s = rec["dot_bytes_per_device"] / HBM_BW
    row.collective_s = rec["collectives"]["total_bytes"] / COLL_BW
    terms = {"compute": row.compute_s, "memory": row.memory_s,
             "collective": row.collective_s}
    row.dominant = max(terms, key=terms.get)
    row.model_flops = model_flops(rec["arch"], rec["shape"])
    row.hlo_flops = rec["flops_per_device"] * chips
    row.useful_ratio = row.model_flops / row.hlo_flops if row.hlo_flops \
        else 0.0
    # fraction of ideal: the time at peak for the MODEL flops over the
    # bound step time
    ideal = row.model_flops / chips / PEAK_FLOPS
    bt = row.bound_time()
    row.roofline_fraction = ideal / bt if bt else 0.0
    row.lower_s = rec.get("lower_s", 0.0)
    return row


def load_rows(dryrun_dir: str, mesh: str | None = "16x16"
              ) -> list[RooflineRow]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if mesh is not None and rec.get("mesh") != mesh:
            continue
        rows.append(row_from_record(rec))
    return rows


def markdown_table(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | status | compute (ms) | memory (ms) | "
           "collective (ms) | dominant | useful (6ND/counted) | "
           "roofline frac |")
    lines = [hdr, "|" + "---|" * 9]
    for r in rows:
        if r.status != "ok":
            lines.append(f"| {r.arch} | {r.shape} | {r.status} | - | - | "
                         "- | - | - | - |")
            continue
        lines.append(
            f"| {r.arch} | {r.shape} | ok | {r.compute_s*1e3:.1f} | "
            f"{r.memory_s*1e3:.1f} | {r.collective_s*1e3:.1f} | "
            f"**{r.dominant}** | {r.useful_ratio:.2f} | "
            f"{r.roofline_fraction:.1%} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    print(markdown_table(load_rows(args.dir, args.mesh)))


if __name__ == "__main__":
    main()
