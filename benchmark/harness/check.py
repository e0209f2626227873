"""The comparison that decides ``correct``.

It judges what the window's runs produced, against the configuration's
own data and the plain reference in ``benchmark/reference``:

- ``count_gap``: every run's candidates, uniques and valid rows at each
  depth from 3 up, as the largest share by which they differ from the
  reference counts in the configuration (a TPU run of the JAX package).
- ``count_d12_mismatch``: the same counts at depths 1-2, which the
  configuration states exact: how many differ.
- ``verdict_mismatch``: the rows of the run the check reads (the window's
  first, whose files stay until the check is done): every valid row, and
  a sample of the stored rejects drawn from the seed, each judged by the
  reference from its spelling; how many stored verdicts it contradicts.
  A row that the reference finds ``undecided`` (an exact solution whose
  relative residual is roundoff over roundoff) contradicts neither
  verdict; the notes count them.
- ``knowns_missing``: the configuration's known solutions with no valid
  row that the program names after them and the reference finds equal
  to them, at the screen points and at points the seed draws.
- ``state_faults``: the audit trail and resume state read back from the
  closed DB file: the run completed at the cell's depth, the generator
  state at depth D with the run's counts and audit setting, as many rows
  a depth as the run reported (every unique when it audits rejects, the
  valid rows alone when it does not), and the jet snapshot and registry
  sidecar on disk.

Each number has its limit in the configuration's ``limits``, set from
sound runs' and the control's readings on the card (``control.py``).
"""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Dict, List, Tuple

import numpy as np

from ..reference import verdict

KINDS = ("candidates", "unique", "valid")


def count_numbers(runs: List[dict], config: dict) -> Dict[str, float]:
    ref = config["counts"]
    gap, d12 = 0.0, 0
    for run in runs:
        got = {st["depth"]: st for st in run["stats"]}
        for d in range(1, config["max_depth"] + 1):
            for k in KINDS:
                want = ref[k][d - 1]
                have = got.get(d, {}).get(k, 0)
                if d <= 2:
                    d12 += int(have != want)
                else:
                    gap = max(gap, abs(have - want) / max(want, 1))
    return {"count_gap": gap, "count_d12_mismatch": d12}


def _connect(db_path: str) -> Tuple[sqlite3.Connection, str]:
    conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    (table,) = conn.execute("SELECT table_name FROM run_metadata").fetchone()
    return conn, table


def state_faults(db_path: str, run: dict, config: dict,
                 audit_rejects: bool) -> List[str]:
    """What is wrong with the stored state, one line each."""
    D = config["max_depth"]
    faults: List[str] = []
    conn, t = _connect(db_path)
    try:
        status, max_depth = conn.execute(
            "SELECT status, max_depth FROM run_metadata").fetchone()
        if status != "completed" or max_depth != D:
            faults.append(f"run_metadata: status {status}, max_depth "
                          f"{max_depth}")
        (raw,) = conn.execute(
            "SELECT state_json FROM generator_progress").fetchone()
        state = json.loads(raw)
        reported = {st["depth"]: st for st in run["stats"]}
        if state.get("completed_depth") != D:
            faults.append(f"generator state at depth "
                          f"{state.get('completed_depth')}, not {D}")
        if bool(state.get("audit_rejects")) != audit_rejects:
            faults.append("generator state's audit_rejects is "
                          f"{state.get('audit_rejects')}")
        saved = {int(d): c for d, c in
                 state.get("by_depth_counts", {}).items()}
        for d in range(1, D + 1):
            st, sv = reported.get(d, {}), saved.get(d, {})
            if (sv.get("generated"), sv.get("valid"),
                    sv.get("candidates")) != (st.get("unique"),
                                              st.get("valid"),
                                              st.get("candidates")):
                faults.append(f"depth {d}: generator state {sv} against "
                              f"the run's {st}")
        stored = {d: (n, v or 0) for d, n, v in conn.execute(
            f"SELECT depth, COUNT(*), SUM(is_valid) FROM {t} GROUP BY depth")}
        for d in range(1, D + 1):
            st = reported.get(d, {})
            n, v = stored.get(d, (0, 0))
            want = st.get("unique") if audit_rejects else st.get("valid")
            if n != want or v != st.get("valid"):
                faults.append(f"depth {d}: {n} rows, {v} valid stored; "
                              f"the run reported {st.get('unique')} "
                              f"uniques, {st.get('valid')} valid")
    finally:
        conn.close()
    snap = db_path + ".jets.d"
    if not (os.path.isdir(snap)
            and any(f.startswith("shard_") for f in os.listdir(snap))):
        faults.append("no jet snapshot shard")
    if not os.path.isfile(db_path + ".registry.npz"):
        faults.append("no registry sidecar")
    return faults


def _rows(conn, table: str, where: str, args=()) -> List[tuple]:
    return conn.execute(f"SELECT id, expression, is_valid, "
                        f"paper_solution_name FROM {table} WHERE {where}",
                        args).fetchall()


def stored_rows(db_path: str, rng: np.random.Generator,
                n_rejects: int) -> List[tuple]:
    """Every valid row and ``n_rejects`` stored rejects drawn by ``rng``:
    (id, expression, is_valid, paper_solution_name)."""
    conn, t = _connect(db_path)
    try:
        valid = _rows(conn, t, "is_valid=1")
        ids = np.array([r[0] for r in conn.execute(
            f"SELECT id FROM {t} WHERE is_valid=0")], np.int64)
        pick = (np.sort(rng.choice(ids, min(n_rejects, len(ids)),
                                   replace=False)) if len(ids) else ids)
        rejects = []
        for lo in range(0, len(pick), 900):
            part = [int(i) for i in pick[lo:lo + 900]]
            rejects += _rows(conn, t, f"id IN ({','.join('?' * len(part))})",
                             part)
    finally:
        conn.close()
    return valid + rejects


def verdict_numbers(rows: List[tuple], config: dict,
                    rng: np.random.Generator) -> Tuple[Dict[str, float],
                                                       List[str]]:
    ref = config["reference"]
    out = verdict.judge([r[1] for r in rows], ref)
    stored = np.array([bool(r[2]) for r in rows])
    wrong = np.flatnonzero((out["solution"] != stored) & ~out["undecided"])
    notes = [f"{int(out['undecided'].sum())} of {len(rows)} rows undecided "
             f"({int((out['undecided'] & stored).sum())} stored valid)"]
    notes += [f"{'valid' if stored[j] else 'reject'} {rows[j][1]!r}: "
             f"reference relres {out['rel_screen'][j]:.3e}, finite "
             f"{bool(out['finite'][j])}, constant "
             f"{bool(out['constant'][j])}" for j in wrong[:10]]
    # the knowns: a valid row named after each, equal to it at the screen
    # points and at points the seed draws in the domain
    pts = np.concatenate([np.asarray(ref["screen_points"], np.float64),
                          verdict.domain_points(rng, ref["domain"], 16)])
    missing = 0
    for expr, name in config["knowns"].items():
        named = [r[1] for r in rows if r[2] and r[3] == name]
        found = False
        if named:
            with np.errstate(all="ignore"):
                want = verdict.values([expr], ref["var_names"], pts)[0]
                have = verdict.values(named, ref["var_names"], pts)
                err = np.max(np.abs(have - want) / (np.abs(want) + 1.0),
                             axis=1)
            found = bool(np.any(err < ref["rtol"]))
        if not found:
            missing += 1
            notes.append(f"known {name!r} ({expr}): {len(named)} rows "
                         "named after it, none equal to it")
    return ({"verdict_mismatch": float(len(wrong)),
             "knowns_missing": float(missing)}, notes)


def judge(runs: List[dict], db_path: str, config: dict,
          audit_rejects: bool, seed: int) -> Tuple[Dict[str, dict], List[str]]:
    """Every compared number with its limit, and notes on what failed."""
    rng = np.random.default_rng(seed)
    nums = count_numbers(runs, config)
    faults = state_faults(db_path, runs[0], config, audit_rejects)
    nums["state_faults"] = float(len(faults))
    rows = stored_rows(db_path, rng, int(config["reject_sample"]))
    vnums, notes = verdict_numbers(rows, config, rng)
    nums.update(vnums)
    limits = config["limits"]
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    return checks, faults + notes


def passed(checks: Dict[str, dict]) -> bool:
    """A number passes when it is at most its limit (an exact comparison
    has the limit 0)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
