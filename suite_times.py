#!/usr/bin/env python3
"""The test suite's time by file, from a pytest JUnit XML report.

Run the tier-1 command with ``--junitxml=PATH`` (with six xdist
workers, ``-p xdist -n 6 --dist loadfile``, one file a worker), then::

    python3 suite_times.py PATH [N]

It prints the summed test time of the whole run and of the port's files
(``tests/test_torch_*.py``), the passes, the N slowest files (time,
passed, skipped, failed) and the N slowest tests. A test's time is its
setup, call and teardown, so a module-scoped fixture (a shared spawned
world, a cached oracle) counts in the first test that uses it. Under
``--dist loadfile`` a file is one worker's unit of work: its summed time
is the least wall time the run can take, and the whole summed time over
the six workers is the wall time of a perfect spread.
"""

import collections
import sys
import xml.etree.ElementTree as ET


def load(path):
    """``({file: [seconds, passed, skipped, failed]}, [(seconds, file,
    test, outcome)])`` of a JUnit XML report."""
    files = collections.defaultdict(lambda: [0.0, 0, 0, 0])
    tests = []
    for case in ET.parse(path).getroot().iter("testcase"):
        module = ".".join(part for part in case.get("classname", "")
                          .split(".") if not part[:1].isupper())
        seconds = float(case.get("time", 0))
        row = files[module]
        row[0] += seconds
        if case.find("skipped") is not None:
            row[2] += 1
            outcome = "skipped"
        elif case.find("failure") is not None or \
                case.find("error") is not None:
            row[3] += 1
            outcome = "failed"
        else:
            row[1] += 1
            outcome = "passed"
        tests.append((seconds, module, case.get("name"), outcome))
    return dict(files), tests


def main(argv):
    files, tests = load(argv[0])
    n = int(argv[1]) if len(argv) > 1 else 30
    port = {k: v for k, v in files.items() if ".test_torch_" in k}
    print(f"summed {sum(v[0] for v in files.values()):.1f} s, port "
          f"{sum(v[0] for v in port.values()):.1f} s; passed "
          f"{sum(v[1] for v in files.values())} (port "
          f"{sum(v[1] for v in port.values())}), failed "
          f"{sum(v[3] for v in files.values())}")
    for name, (secs, passed, skipped, failed) in sorted(
            files.items(), key=lambda kv: -kv[1][0])[:n]:
        print(f"{secs:9.1f} s {passed:4d} passed {skipped:4d} skipped "
              f"{failed:3d} failed  {name}")
    print("slowest tests:")
    for secs, module, name, outcome in sorted(tests, reverse=True)[:n]:
        print(f"{secs:9.1f} s {outcome:7s} {module}::{name}")
    for secs, module, name, outcome in tests:
        if outcome == "failed":
            print(f"failed: {module}::{name}")


if __name__ == "__main__":
    main(sys.argv[1:])
