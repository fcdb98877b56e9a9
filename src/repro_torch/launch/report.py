"""Render the dry run's tables from its JSON records
(`repro/launch/report.py`).

  PYTHONPATH=src python -m repro_torch.launch.report [--mesh 16x16] [--section roofline|dryrun] [--root reports/dryrun]

On records in the reference's shape the tables are the reference's,
byte for byte.  On the port's records (`launch/dryrun.py`) the dry-run
table's seconds column is the count's (``count_s``) and its header says
so, and a peak without temporaries (``device_bytes.temp`` null: the
meta arguments + outputs − aliases) is marked † with a note under the
table.
"""
from __future__ import annotations

import argparse
import glob
import json

DRYRUN_ROOT = "reports/dryrun"
NO_TEMP_NOTE = ("† meta: arguments + outputs − aliases per chip, no "
                "temporaries (a card's peak: `launch/perf.py --mem`)")


def load(mesh, root: str = DRYRUN_ROOT):
    out = []
    for f in sorted(glob.glob(f"{root}/{mesh}/*.json")):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def dryrun_table(mesh, root: str = DRYRUN_ROOT):
    recs = load(mesh, root)
    counted = any("count_s" in r for r in recs)
    rows = ["| arch | shape | status | peak GiB/chip | "
            + ("count s" if counted else "compile s")
            + " | collectives in module |",
            "|---|---|---|---:|---:|---|"]
    marked = False
    for r in recs:
        if r.get("skipped"):
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP "
                        f"({r['skip_reason'][:40]}…) | | | |")
            continue
        coll = ", ".join(f"{k}:{fmt_bytes(v)}G"
                         for k, v in sorted(r["collectives_in_module"].items())
                         if v > 0)
        db = r["device_bytes"]
        mark = "†" if db.get("temp", 0) is None else ""
        marked = marked or bool(mark)
        secs = r["count_s"] if "count_s" in r else r["compile_s"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | OK | "
            f"{db['peak_gib']:.2f}{mark} | {secs:.0f} | "
            f"{coll} |")
    if marked:
        rows += ["", NO_TEMP_NOTE]
    return "\n".join(rows)


def roofline_table(mesh, root: str = DRYRUN_ROOT):
    rows = ["| arch | shape | bound | t_comp ms | t_mem ms | t_coll ms | "
            "useful | roofline-frac |",
            "|---|---|---|---:|---:|---:|---:|---:|"]
    for r in load(mesh, root):
        if r.get("skipped") or "roofline" not in r:
            continue
        x = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {x['bound']} | "
            f"{x['t_compute']*1e3:.1f} | {x['t_memory']*1e3:.1f} | "
            f"{x['t_collective']*1e3:.1f} | {x['useful_ratio']:.2f} | "
            f"{x['mfu_bound']:.3f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--section", default="roofline")
    ap.add_argument("--root", default=DRYRUN_ROOT)
    a = ap.parse_args(argv)
    if a.section == "dryrun":
        print(dryrun_table(a.mesh, a.root))
    else:
        print(roofline_table(a.mesh, a.root))


if __name__ == "__main__":
    main()
