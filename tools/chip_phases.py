"""Run chosen phases of chip_smoke.py from several checkouts, in turns, on
one card: the way to compare a parent and a change inside one call.

Usage (from the repo root, on the machine with the card):

    python3 tools/chip_phases.py PARENT:groupby,hits .:groupby,hits \\
        .:groupby,hits PARENT:groupby,hits

Each argument is ``checkout:phase,phase``; phases are ``groupby``
(sql_groupby), ``join`` (sql_join), ``binary`` (sql_binary), ``hits`` (sql_hits), ``arrays``
(sql_arrays), ``subquery`` (sql_subquery), ``text`` (sql_text),
``storage`` (sql_storage), ``views`` (sql_views), ``formats``
(sql_formats), ``server`` (sql_server), ``distributed``
(sql_distributed) and ``config5`` (config 5's fused step alone,
sql_distributed's ``phase_config5``), the ones a checkout's chip_smoke.py
has.
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
names = {'groupby': 'phase_groupby', 'join': 'phase_sql_join',
         'binary': 'phase_sql_binary',
         'hits': 'phase_sql_hits', 'arrays': 'phase_sql_arrays',
         'subquery': 'phase_sql_subquery', 'text': 'phase_sql_text',
         'storage': 'phase_sql_storage', 'views': 'phase_sql_views',
         'formats': 'phase_sql_formats', 'server': 'phase_sql_server',
         'distributed': 'phase_sql_distributed'}
for ph in sys.argv[1].split(','):
    if ph == 'config5':
        out, _ = C.phase_config5(0, C.nvidia_smi_line())
        C.emit({'phase': 'sql_distributed.config5', **out})
    else:
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
        if d.get("phase") == "sql_join":
            print(f"  sql_join aggregate median {d['median_query_ms']:.3f} "
                  + " ".join(f"{k} {st['ms']:.3f} ({st['rows']} rows)"
                             for k, st in d["statements"].items()))
        if d.get("phase") == "sql_binary":
            print(f"  sql_binary load_s {d['load_s']:.3f} median "
                  f"{d['median_query_ms']:.3f}")
        if d.get("phase") == "sql_views":
            ins = d["insert"]
            print(f"  sql_views insert {ins['rows_per_s']:.0f} rows/s "
                  f"(no view {ins['no_view_rows_per_s']:.0f}), last batch "
                  f"device {ins['profiled_last_batch']['device_ms_per_query']:.3f}"
                  f" of {ins['profiled_last_batch']['wall_ms_per_query']:.3f} ms")
        for name, st in d.get("served", {}).items():
            print(f"  sql_server {name} qps {st['qps']:.1f} p50 "
                  f"{st['p50_ms']:.3f} p99 {st['p99_ms']:.3f} ms, served - "
                  f"in-process {st['served_minus_in_process_ms']:.3f} ms")
        for name, st in d.get("steps", {}).items():
            dev = f"{st['device_s']:.3f} s" if st["device_s"] is not None \
                else f"not measured (profile {st['profile_device_s']:.3f} s)"
            print(f"  {d['phase']} {name} {st['seconds']:.3f} s "
                  f"{st['rows_per_s']:.0f} rows/s device {dev}")
        if d.get("phase") == "sql_distributed.config5":
            for tag, r in d["runs"].items():
                ov = r.get("overlap", {}).get("overlap_ms")
                print(f"  config5 {tag} median {r['median_ms']:.3f} "
                      f"ms {[round(v, 3) for v in r['ms']]} "
                      f"exchange {r['parts']['exchange_ms']:.3f} host syncs "
                      f"{r.get('host_syncs_per_step')} busy "
                      f"{r['device_busy_share']:.3f} device "
                      f"{r['device_ms_per_step']:.3f} queued "
                      f"{r.get('host_queue_ms')} overlap_ms {ov}")
        if d.get("phase") == "sql_distributed.multi_card":
            print(f"  multi_card {json.dumps(d)[:300]}")
        if "device_split_probe" in d:
            print(f"  {d['phase']} device_split_probe "
                  f"{json.dumps(d['device_split_probe'])}")
        stmts = {**d.get("per_statement", {}), **d.get("reads", {}),
                 **d.get("lookups", {})}
        for name, st in stmts.items():
            if "median_ms" not in st:      # sql_distributed's pairs
                st = st.get("distributed", {})
                if "median_ms" not in st:
                    continue
            dev = st.get("device_ms_per_query")
            print(f"  {d['phase']} {name} median {st['median_ms']:.3f} "
                  + (f"device {dev:.3f} " if dev is not None else "")
                  + f"busy {st['device_busy_share']:.3f}")


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
