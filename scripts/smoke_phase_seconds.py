"""Seconds each chip_smoke phase took, from the stamped logs that
scripts/parent_change_smoke.sh writes, and the profile_lv records it
gathered.

    python3 scripts/smoke_phase_seconds.py chiprun_out/m20

A line's seconds are the time since the line before it, summed by the
phase that line names (lines naming no phase: "other"). Columns: one a
run (smoke_p1, smoke_c1, ...), a cut run up to its last line.
"""

import collections
import json
import sys
from pathlib import Path


def phase_seconds(log: Path) -> dict[str, float]:
    acc: dict[str, float] = collections.OrderedDict()
    prev = 0.0
    for line in log.read_text().splitlines():
        stamp, _, rest = line.partition(" ")
        try:
            t = float(stamp)
        except ValueError:
            continue
        name = "other"
        if rest.startswith("{"):
            try:
                d = json.loads(rest)
            except ValueError:
                d = {}
            name = d.get("phase") or ("kernels" if "kernels" in d else
                                      "ok" if "ok" in d else "other")
        acc[name] = acc.get(name, 0.0) + (t - prev)
        prev = t
    acc["TOTAL"] = prev
    return acc


def main(out: str) -> None:
    out = Path(out)
    label = None
    for line in (out / "profile.jsonl").read_text().splitlines():
        d = json.loads(line)
        if "tree" in d:
            label = d
            continue
        print(label["tree"], label["impl"], label["adjoint"], d["iters"],
              f"wall_ms={d['wall_ms_per_iter']}",
              f"busy_ms={d['device_busy_ms_per_iter']}",
              f"idle={d['device_idle_share']}", f"eval_ms={d['eval_ms']}",
              d["card"])
    runs = {p.stem[len("smoke_"):]: phase_seconds(p)
            for p in sorted(out.glob("smoke_*.log"))}
    names = [k for k in dict.fromkeys(k for r in runs.values() for k in r)
             if k != "TOTAL"] + ["TOTAL"]
    print(f"{'phase':28s}" + "".join(f"{k:>10s}" for k in runs))
    for n in names:
        print(f"{n:28s}" + "".join(f"{r.get(n, 0.0):10.1f}"
                                   for r in runs.values()))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "chiprun_out/m20")
