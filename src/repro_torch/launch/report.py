"""Render the roofline tables from dry-run results
(``repro.launch.report``'s counterpart).

  PYTHONPATH=src python -m repro_torch.launch.report \\
      [--dir results/dryrun_torch] [--jsonl metrics.jsonl] [--md]

Rows come in ``repro``'s order of archs and shapes; ``fits80G`` says
whether the counted peak fits one H100's 80 GB. The tables: one card's
roofline, one rank's of the 16 worker ranks of ``repro``'s single-pod
mesh (``MESH_16``), and which combos have a count over the 32 ranks of
its multi-pod mesh (``multipod_status``, ``repro``'s table).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .dryrun import MESH, MESHES, mesh_name

MESH_16 = mesh_name(MESHES["16x16"])
MESH_32 = mesh_name(MESHES["2x16x16"])

ORDER_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ORDER_ARCHS = ["whisper-medium", "qwen3-1.7b", "starcoder2-7b",
               "phi-3-vision-4.2b", "zamba2-7b", "granite-moe-3b-a800m",
               "minitron-4b", "mamba2-2.7b", "mixtral-8x7b", "llama3-405b"]
CARD_BYTES = 80e9


def load(dir_):
    out = {}
    for f in glob.glob(os.path.join(dir_, "*.json")):
        try:
            with open(f) as fh:
                d = json.load(fh)
        except (OSError, ValueError):
            continue
        out[(d["arch"], d["shape"], d["mesh"])] = d
    return out


def load_jsonl(path):
    """Dry-run results from a telemetry JSONL: ``kind: "dryrun"`` records
    carry the whole result beside their ``launch.*`` gauges. Later records
    win (a rerun updates)."""
    from ..obs.sinks import read_jsonl

    out = {}
    for rec in read_jsonl(path):
        if rec.get("kind") != "dryrun" or "result" not in rec:
            continue
        d = rec["result"]
        out[(d["arch"], d["shape"], d["mesh"])] = d
    return out


def fmt_s(x):
    if x == 0:
        return "0"
    for unit, scale in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6)):
        if x >= scale:
            return f"{x / scale:.2f}{unit}"
    return f"{x:.1e}s"


def roofline_table(res, mesh=MESH, md=True):
    hdr = ["arch", "shape", "mode", "compute", "memory", "collective",
           "bottleneck", "useful", "peakGB", "fits80G"]
    rows = []
    for arch in ORDER_ARCHS:
        for shape in ORDER_SHAPES:
            d = res.get((arch, shape, mesh))
            if d is None:
                rows.append([arch, shape, "MISSING"] + [""] * 7)
                continue
            peak = d["peak_memory_bytes"] / 1e9
            mode = d["mode"] or "-"
            rows.append([
                arch, shape,
                mode + (f" [{d['variant']}]" if d["variant"] else ""),
                fmt_s(d["compute_s"]), fmt_s(d["memory_s"]),
                fmt_s(d["collective_s"]), d["bottleneck"],
                f"{d['useful_flops_ratio']:.2f}", f"{peak:.1f}",
                "yes" if peak <= CARD_BYTES / 1e9 else "NO",
            ])
    if md:
        lines = ["| " + " | ".join(hdr) + " |",
                 "|" + "---|" * len(hdr)]
        for r in rows:
            lines.append("| " + " | ".join(str(x) for x in r) + " |")
        return "\n".join(lines)
    w = [max(len(str(r[i])) for r in [hdr] + rows) for i in range(len(hdr))]
    lines = ["  ".join(str(h).ljust(w[i]) for i, h in enumerate(hdr))]
    for r in rows:
        lines.append("  ".join(str(x).ljust(w[i]) for i, x in enumerate(r)))
    return "\n".join(lines)


def multipod_status(res, mesh=MESH_32):
    """``repro``'s multi-pod status table: "ok" where ``res`` has a count
    of the combo over ``mesh``, "-" where not."""
    out = ["| arch | " + " | ".join(ORDER_SHAPES) + " |",
           "|" + "---|" * (len(ORDER_SHAPES) + 1)]
    for arch in ORDER_ARCHS:
        row = [arch] + ["ok" if (arch, shape, mesh) in res else "-"
                        for shape in ORDER_SHAPES]
        out.append("| " + " | ".join(row) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--jsonl", default=None,
                    help="also load dryrun records from this telemetry "
                    "JSONL (obs.sinks wire format); overrides --dir dupes")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    res = load(args.dir)
    if args.jsonl:
        res.update(load_jsonl(args.jsonl))
    print(f"# loaded {len(res)} results from {args.dir}"
          f"{' + ' + args.jsonl if args.jsonl else ''}\n")
    print(f"## Roofline (one NVIDIA H100, {MESH}; reckoned against its "
          f"published peaks)\n")
    print(roofline_table(res, MESH, md=args.md))
    print(f"\n## Roofline (one of the 16 worker ranks of repro's single-pod "
          f"mesh, {MESH_16}; the model axis not sharded)\n")
    print(roofline_table(res, MESH_16, md=args.md))
    print(f"\n## Multi-pod ({MESH_32}: the 32 worker ranks of repro's "
          f"2x16x16) count status\n")
    print(multipod_status(res))


if __name__ == "__main__":
    main()
