"""Merge ladder run files (frontends/ladder.py rows) into one table.
Rows are keyed by (rung, variant, mode); later files win,
so re-runs supersede.  Rungs not re-run this round carry forward with
a ``carried_from`` marker rather than silently posing as fresh."""

import json
import sys

ORDER = ["test", "yeast", "dblp", "youtube", "youtube_skew",
         "patents", "synth100m"]


def key(r):
    return (r["rung"], r["variant"], r.get("mode", "-"))


def main(out, files_with_tags):
    rows = {}
    for path, tag in files_with_tags:
        for line in open(path):
            line = line.strip()
            if not line:
                continue
            for r in (json.loads(line) if line.startswith("[")
                      else [json.loads(line)]):
                if tag:
                    r["carried_from"] = tag
                rows[key(r)] = r
    ordered = sorted(rows.values(),
                     key=lambda r: (ORDER.index(r["rung"]),
                                    r["variant"], r.get("mode", "-")))
    with open(out, "w") as f:
        for r in ordered:
            f.write(json.dumps(r) + "\n")
    print(f"wrote {len(ordered)} rows to {out}")


if __name__ == "__main__":
    out = sys.argv[1]
    pairs = []
    for a in sys.argv[2:]:
        path, _, tag = a.partition("=")
        pairs.append((path, tag))
    main(out, pairs)
