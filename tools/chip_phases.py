"""Run chosen phases of chip_smoke.py from several checkouts, in turns, on
one card: the way to compare a parent and a change inside one call.

Usage (from the repo root, on the machine with the card):

    python3 tools/chip_phases.py PARENT:groupby,hits .:groupby,hits \\
        .:groupby,hits PARENT:groupby,hits

Each argument is ``checkout:phase,phase``; phases are ``groupby``
(sql_groupby), ``binary`` (sql_binary), ``hits`` (sql_hits), ``arrays``
(sql_arrays), ``subquery`` (sql_subquery), ``text`` (sql_text),
``storage`` (sql_storage) and ``views`` (sql_views), the ones a
checkout's chip_smoke.py has.
Each argument runs in a process of its own with the checkout as the
working directory (so it imports that checkout's package and builds its
kernels), after that checkout's kernel build.  The full output of run i
goes to ``chiprun_out/phases_<i>.log``; stdout gets each statement's
median and device busy share."""

import json
import os
import subprocess
import sys
import time

RUN = """
import sys, torch
sys.path.insert(0, '.')
import chip_smoke as C
from myscaledb_tpu_torch.ops.kernels import build
build.build(); build.library()
if hasattr(build, 'host_library'):   # older checkouts have none
    build.host_library()
torch.backends.cuda.matmul.allow_tf32 = False
names = {'groupby': 'phase_groupby', 'binary': 'phase_sql_binary',
         'hits': 'phase_sql_hits', 'arrays': 'phase_sql_arrays',
         'subquery': 'phase_sql_subquery', 'text': 'phase_sql_text',
         'storage': 'phase_sql_storage', 'views': 'phase_sql_views'}
for ph in sys.argv[1].split(','):
    getattr(C, names[ph])(0)
"""


def summarize(stdout: str) -> None:
    for ln in stdout.splitlines():
        if not ln.startswith("{"):
            continue
        d = json.loads(ln)
        if d.get("phase") == "sql_groupby":
            prof = d.get("profile_3_queries", {})
            print(f"  sql_groupby median {d['median_query_ms']:.3f} "
                  f"busy {prof.get('device_busy_share', 0):.3f}")
        if d.get("phase") == "sql_binary":
            print(f"  sql_binary load_s {d['load_s']:.3f} median "
                  f"{d['median_query_ms']:.3f}")
        if d.get("phase") == "sql_views":
            ins = d["insert"]
            print(f"  sql_views insert {ins['rows_per_s']:.0f} rows/s "
                  f"(no view {ins['no_view_rows_per_s']:.0f}), last batch "
                  f"device {ins['profiled_last_batch']['device_ms_per_query']:.3f}"
                  f" of {ins['profiled_last_batch']['wall_ms_per_query']:.3f} ms")
        stmts = {**d.get("per_statement", {}), **d.get("reads", {}),
                 **d.get("lookups", {})}
        for name, st in stmts.items():
            print(f"  {d['phase']} {name} median {st['median_ms']:.3f} "
                  f"device {st['device_ms_per_query']:.3f} "
                  f"busy {st['device_busy_share']:.3f}")


def main() -> int:
    os.makedirs("chiprun_out", exist_ok=True)
    rc = 0
    for i, spec in enumerate(sys.argv[1:]):
        tree, phases = spec.split(":")
        t0 = time.time()
        r = subprocess.run([sys.executable, "-c", RUN, phases], cwd=tree,
                           capture_output=True, text=True)
        with open(f"chiprun_out/phases_{i}.log", "w") as f:
            f.write(r.stdout + "\n" + r.stderr)
        print(f"run {i}: {tree} {phases} rc {r.returncode} "
              f"{time.time() - t0:.1f} s", flush=True)
        summarize(r.stdout)
        if r.returncode:
            print(r.stderr[-3000:])
            rc = r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
