"""Sums a pytest junit XML's ``<testcase time>`` per test file.

    python tests/junit_times.py RUN.xml [--top N] [--match GLOB]
                                        [--before OLD.xml]

prints one line per file, heaviest first: summed seconds, share of the
whole, test count, file; then the total over the files shown and over
all.  ``--match`` keeps the files whose name matches the glob (e.g.
``'test_torch_*'`` for the port's).  Two runs side by side: ``--before
OLD.xml`` adds each file's seconds in OLD and the change.  The times
are pytest's own (each test's setup, call and teardown), so under ``-n``
they overlap in wall time; the junit root's ``time`` is not the wall of
an xdist run.
"""
import argparse
import fnmatch
import xml.etree.ElementTree as ET
from collections import defaultdict


def per_file(path):
    """{file name: [summed seconds, test cases]} from a junit XML."""
    out = defaultdict(lambda: [0.0, 0])
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("classname", "").split(".")[-1] + ".py"
        f = case.get("file")
        if f:
            name = f.rsplit("/", 1)[-1]
        out[name][0] += float(case.get("time") or 0.0)
        out[name][1] += 1
    return dict(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("xml")
    ap.add_argument("--top", type=int, default=0)
    ap.add_argument("--match", default="*")
    ap.add_argument("--before")
    a = ap.parse_args(argv)
    files = per_file(a.xml)
    total = sum(s for s, _ in files.values())
    shown = {f: v for f, v in files.items() if fnmatch.fnmatch(f, a.match)}
    old = per_file(a.before) if a.before else {}
    rows = sorted(shown.items(), key=lambda kv: -kv[1][0])
    if a.top:
        rows = rows[:a.top]
    for f, (s, n) in rows:
        extra = ""
        if a.before:
            b = old.get(f, [0.0, 0])[0]
            extra = f"  before {b:9.1f}  change {s - b:+9.1f}"
        print(f"{s:9.1f} s  {100 * s / total:5.1f}%  {n:4d}  {f}{extra}")
    part = sum(s for _, (s, _) in rows)
    line = f"files shown: {part:.1f} s of {total:.1f} s in all"
    if a.before:
        ob = (sum(old.get(f, [0.0, 0])[0] for f, _ in rows) if a.top
              else sum(s for f, (s, _) in old.items()
                       if fnmatch.fnmatch(f, a.match)))
        line += f"; before {ob:.1f} s ({100 * (part - ob) / ob:+.1f}%)" \
            if ob else ""
    print(line)


if __name__ == "__main__":
    main()
