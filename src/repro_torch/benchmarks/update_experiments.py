"""Fill an EXPERIMENTS.md's markers from dry-run records: the reference's
``tools/update_experiments.py`` over ``launch/dryrun.py``'s records.

``<!-- ROOFLINE_TABLE -->`` becomes ``roofline.analysis``'s table of the
tuned records (H100 peaks), also written to ``roofline_table.md`` beside
them; ``<!-- PERF_TABLE -->`` becomes the baseline-against-tuned table of
``PERF_CELLS``.

  PYTHONPATH=src python -m repro_torch.benchmarks.update_experiments \\
      [--experiments EXPERIMENTS.md] [--tuned experiments/dryrun] \\
      [--baseline experiments/dryrun_baseline] \\
      [--out experiments/roofline_table.md]

The defaults are the reference's layout under the repository root.  The
port's records carry no ``temp_size_in_bytes`` (``launch/dryrun.py``
counts no buffer assignment): such a cell's temp row says "not counted"
and gives no FITS/OOM verdict.
"""

from __future__ import annotations

import argparse
import json
import os

from ..roofline.analysis import load_rows, markdown_table, row_from_record

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
EXP = os.path.join(ROOT, "EXPERIMENTS.md")
TUNED = os.path.join(ROOT, "experiments", "dryrun")
BASE = os.path.join(ROOT, "experiments", "dryrun_baseline")
OUT = os.path.join(ROOT, "experiments", "roofline_table.md")

PERF_CELLS = [("starcoder2-7b", "prefill_32k"),
              ("gemma3-27b", "train_4k"),
              ("deepseek-v2-lite-16b", "train_4k"),
              ("granite-moe-1b-a400m", "train_4k"),
              ("internlm2-20b", "decode_32k"),
              ("llama-3.2-vision-90b", "train_4k")]

#: A cell FITS where its temp and argument bytes stay under this many GiB
#: a device: the H100 SXM's 80 GB of HBM3 (data sheet; 74.5 GiB) less 2 GiB
#: of headroom for the CUDA context and the allocator, as the reference
#: keeps 2 GiB of its device's memory free.
FIT_LIMIT_GIB = 80e9 / 2**30 - 2.0


def _load(d, arch, shape):
    p = os.path.join(d, f"{arch}_{shape}_16-16.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _temp_gib(rec) -> float | None:
    temp = rec["memory"].get("temp_size_in_bytes")
    return None if temp is None else temp / 2**30


def _temp_cell(rec, temp: float | None) -> str:
    if temp is None:
        return "not counted"
    fits = temp + rec["memory"]["argument_size_in_bytes"] / 2**30 \
        < FIT_LIMIT_GIB
    return f"{temp:.1f} ({'FITS' if fits else 'OOM'})"


def perf_table(tuned: str = TUNED, base: str = BASE) -> str:
    lines = ["| cell | metric | baseline | tuned | change |",
             "|---|---|---|---|---|"]
    for arch, shape in PERF_CELLS:
        b = _load(base, arch, shape)
        t = _load(tuned, arch, shape)
        if not b or not t or b["status"] != "ok" or t["status"] != "ok":
            continue
        rb, rt = row_from_record(b), row_from_record(t)
        bt, tt = _temp_gib(b), _temp_gib(t)
        bc = b["collectives"]["total_bytes"] / 2**30
        tc = t["collectives"]["total_bytes"] / 2**30
        change = f"{tt/bt:.2f}x" if bt and tt is not None else "—"
        cell = f"{arch} × {shape}"
        lines.append(f"| {cell} | temp GiB/chip | {_temp_cell(b, bt)} | "
                     f"{_temp_cell(t, tt)} | {change} |")
        lines.append(f"| | collective GiB/chip | {bc:.1f} | {tc:.1f} | "
                     f"{tc/bc:.2f}x |")
        bb, tb = rb.bound_time(), rt.bound_time()
        lines.append(f"| | bound step time (s) | {bb:.2f} | {tb:.2f} | "
                     f"{tb/bb:.2f}x |")
        lines.append(f"| | roofline frac | {rb.roofline_fraction:.1%} | "
                     f"{rt.roofline_fraction:.1%} | — |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--experiments", default=EXP,
                    help="the markdown file whose markers are filled")
    ap.add_argument("--tuned", default=TUNED,
                    help="the tuned dry-run records")
    ap.add_argument("--baseline", default=BASE,
                    help="the baseline dry-run records")
    ap.add_argument("--out", default=OUT,
                    help="where the roofline table is written")
    args = ap.parse_args(argv)

    rows = load_rows(args.tuned, "16x16")
    table = markdown_table(rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(table + "\n")
    with open(args.experiments) as f:
        text = f.read()
    text = text.replace("<!-- ROOFLINE_TABLE -->", table)
    text = text.replace("<!-- PERF_TABLE -->",
                        perf_table(args.tuned, args.baseline))
    with open(args.experiments, "w") as f:
        f.write(text)
    ok = sum(1 for r in rows if r.status == "ok")
    print(f"updated {os.path.basename(args.experiments)}: {len(rows)} rows "
          f"({ok} ok)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
