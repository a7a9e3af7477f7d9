"""
Pure-stdlib summarization and validation of recorder JSONL telemetry.
Counterpart of :mod:`magicsoup_tpu.telemetry.summary`, copied so that
for the same JSONL both packages give the same output.

Free of torch and numpy imports on purpose, so a capture is processed
(``python -m magicsoup_tpu_torch.telemetry``) without initializing a
device.

Row schema (one JSON object per line; ``type`` discriminates):

- ``meta``     — one per attach: ``{"version": 1, "wall": <epoch s>}``.
- ``counters`` — process-total runtime counters (compiles, persistent
  cache, phenotype cache, D2H fetches) at attach / flush boundaries.
- ``step``     — one per simulation step, built from the on-device
  metric lanes of the packed step record plus host replay bookkeeping:
  ``step``, ``alive``, ``rows``, ``occupied``, ``mm_mass``, ``cm_mass``,
  per-step ``kills``/``divisions``/``spawned``, genome-length stats,
  and cumulative ``total_*`` counters (monotone by contract).
- ``dispatch`` — one per host dispatch: ``k`` (megastep), queue depth,
  cold/compact flags, and ``phases`` mapping phase name -> milliseconds
  spent since the previous dispatch row.
- ``accounting`` — one per tenant from the graftserve ledger
  (``serve.accounting.TenantAccount.row``): ``tenant``, ``world``, and
  the non-negative usage counters in ``ACCOUNTING_COUNTER_KEYS``
  (steps/megasteps/dispatches, fetch bytes, device microseconds, and
  health trips).

Mesh-placed runs add optional keys: step rows carry ``tile_occupancy``
(per-map-row-tile occupied pixel counts, one int per mesh tile, summing
to ``occupied`` — computed on device from the sharded occupancy map) and
dispatch rows carry ``tiles``/``mesh_axis``.  Single-device rows omit
them, so the schema is backward compatible.

Fleet runs annotate dispatch rows with ``fleet_slot``/``fleet_size``;
cross-rung FUSED dispatches additionally carry ``fused_groups`` (how
many rung groups shared the one program launch, a positive int) and
``envelope`` (``[k_env, rec_env]`` — the grow-only record envelope the
shared fetch buffer was padded to).  Both are optional; when
``envelope`` is present ``fused_groups`` must be too.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

# keys every step row must carry (the on-device metric lanes)
REQUIRED_STEP_KEYS = (
    "step",
    "alive",
    "rows",
    "occupied",
    "mm_mass",
    "cm_mass",
)
# cumulative counters that must never decrease across step rows
MONOTONE_STEP_KEYS = (
    "step",
    "total_kills",
    "total_divisions",
    "total_spawned",
    "total_mutations",
)
# per-tenant usage counters every accounting row must carry
# (serve.accounting._COUNTER_FIELDS — pinned here so the stdlib-pure
# validator and the ledger cannot drift without a test noticing)
ACCOUNTING_COUNTER_KEYS = (
    "steps",
    "megasteps",
    "dispatches",
    "fetch_bytes",
    "device_us",
    "sentinel_trips",
    "invariant_trips",
)


def read_jsonl(path) -> list[dict]:
    """Parse a JSONL telemetry file into row dicts (blank lines skipped).

    Raises ``ValueError`` naming the offending line number on malformed
    JSON — a truncated final line from a crashed run is the common case,
    and the line number makes it obvious.
    """
    rows: list[dict] = []
    with open(Path(path), "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: malformed JSONL row: {e}"
                ) from e
    return rows


def percentile(values, q: float) -> float:
    """Nearest-rank-with-interpolation percentile (q in [0, 100]).

    Matches numpy's default 'linear' method so the published p50/p95
    stay comparable if a future consumer recomputes them with numpy.
    """
    vals = sorted(float(v) for v in values)
    if not vals:
        return math.nan
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def phase_quantiles(rows: list[dict]) -> dict[str, dict]:
    """Per-phase timing stats from the ``dispatch`` rows' ``phases``."""
    samples: dict[str, list[float]] = {}
    for row in rows:
        if row.get("type") != "dispatch":
            continue
        for name, ms in (row.get("phases") or {}).items():
            samples.setdefault(name, []).append(float(ms))
    out: dict[str, dict] = {}
    for name in sorted(samples):
        vals = samples[name]
        out[name] = {
            "n": len(vals),
            "p50_ms": round(percentile(vals, 50), 4),
            "p95_ms": round(percentile(vals, 95), 4),
            "max_ms": round(max(vals), 4),
            "total_ms": round(sum(vals), 4),
        }
    return out


def counter_deltas(rows: list[dict]) -> dict[str, dict]:
    """first/last/delta for every counter across the ``counters`` rows."""
    first: dict[str, float] = {}
    last: dict[str, float] = {}
    for row in rows:
        if row.get("type") != "counters":
            continue
        for name, val in (row.get("counters") or {}).items():
            first.setdefault(name, val)
            last[name] = val
    return {
        name: {
            "first": first[name],
            "last": last[name],
            "delta": last[name] - first[name],
        }
        for name in sorted(first)
    }


def validate_rows(rows: list[dict]) -> list[str]:
    """Schema check; returns human-readable problems (empty == valid).

    The gate the CI smoke runs: required keys on every step row, the
    ``step`` index strictly increasing, cumulative counters monotone,
    and dispatch phase timings well-formed non-negative numbers.
    """
    problems: list[str] = []
    prev_step: dict[str, float] = {}
    prev_index: float | None = None
    for i, row in enumerate(rows):
        where = f"row {i}"
        if not isinstance(row, dict) or "type" not in row:
            problems.append(f"{where}: not an object with a 'type' key")
            continue
        kind = row["type"]
        if kind == "step":
            missing = [k for k in REQUIRED_STEP_KEYS if k not in row]
            if missing:
                problems.append(f"{where}: step row missing {missing}")
                continue
            if prev_index is not None and row["step"] <= prev_index:
                problems.append(
                    f"{where}: step index {row['step']} not increasing "
                    f"(previous {prev_index})"
                )
            prev_index = row["step"]
            for key in MONOTONE_STEP_KEYS:
                if key not in row:
                    continue
                if key in prev_step and row[key] < prev_step[key]:
                    problems.append(
                        f"{where}: {key} decreased "
                        f"({prev_step[key]} -> {row[key]})"
                    )
                prev_step[key] = row[key]
            tiles = row.get("tile_occupancy")
            if tiles is not None:
                if not isinstance(tiles, list) or any(
                    not isinstance(v, int) or v < 0 for v in tiles
                ):
                    problems.append(
                        f"{where}: tile_occupancy must be a list of"
                        f" non-negative ints, got {tiles!r}"
                    )
                elif sum(tiles) != row["occupied"]:
                    problems.append(
                        f"{where}: tile_occupancy sums to {sum(tiles)}"
                        f" but occupied={row['occupied']}"
                    )
        elif kind == "dispatch":
            phases = row.get("phases")
            if not isinstance(phases, dict):
                problems.append(f"{where}: dispatch row missing 'phases'")
                continue
            for name, ms in phases.items():
                if not isinstance(ms, (int, float)) or ms < 0:
                    problems.append(
                        f"{where}: phase {name!r} timing {ms!r} invalid"
                    )
            # cross-rung fused dispatch tags (fleet.scheduler
            # _dispatch_fused): how many rung groups shared this one
            # program launch, and the grow-only [k_env, rec_env] record
            # envelope its fetch buffer was padded to
            fused = row.get("fused_groups")
            if fused is not None and (
                not isinstance(fused, int) or fused < 1
            ):
                problems.append(
                    f"{where}: fused_groups must be a positive int, "
                    f"got {fused!r}"
                )
            env = row.get("envelope")
            if env is not None:
                if (
                    not isinstance(env, list)
                    or len(env) != 2
                    or any(not isinstance(v, int) or v < 1 for v in env)
                ):
                    problems.append(
                        f"{where}: envelope must be [k_env, rec_env] "
                        f"positive ints, got {env!r}"
                    )
                elif fused is None:
                    problems.append(
                        f"{where}: envelope without fused_groups — "
                        "fused tags must travel together"
                    )
        elif kind == "counters":
            if not isinstance(row.get("counters"), dict):
                problems.append(f"{where}: counters row missing 'counters'")
        elif kind == "sentinel":
            # graftguard health-sentinel trip (stepper._handle_sentinel)
            if not isinstance(row.get("flags"), int) or "step" not in row:
                problems.append(
                    f"{where}: sentinel row missing 'flags'/'step'"
                )
        elif kind == "invariant":
            # graftcheck invariant-lane trip (stepper._handle_invariant)
            if not isinstance(row.get("flags"), int) or "step" not in row:
                problems.append(
                    f"{where}: invariant row missing 'flags'/'step'"
                )
        elif kind == "accounting":
            # graftserve per-tenant usage ledger (serve.accounting)
            if not isinstance(row.get("tenant"), str):
                problems.append(f"{where}: accounting row missing 'tenant'")
                continue
            if not isinstance(row.get("world"), int):
                problems.append(f"{where}: accounting row missing 'world'")
            for key in ACCOUNTING_COUNTER_KEYS:
                val = row.get(key)
                if not isinstance(val, int) or val < 0:
                    problems.append(
                        f"{where}: accounting counter {key!r} must be a"
                        f" non-negative int, got {val!r}"
                    )
        elif kind == "warden":
            # graftwarden world-level event (quarantine / heal /
            # heal_failed / circuit_break / save_degraded /
            # save_recovered — fleet.warden.FleetWarden)
            if not isinstance(row.get("event"), str) or "step" not in row:
                problems.append(
                    f"{where}: warden row missing 'event'/'step'"
                )
        elif kind == "chaos":
            # graftchaos fault firing (guard.chaos.site) — drained from
            # the chaos event ring at counter-emit boundaries
            if not isinstance(row.get("site"), str) or not isinstance(
                row.get("kind"), str
            ):
                problems.append(f"{where}: chaos row missing 'site'/'kind'")
        elif kind == "degraded":
            # graceful-degradation transition (guard.chaos.note_degraded
            # / clear_degraded)
            if not isinstance(row.get("subsystem"), str) or row.get(
                "state"
            ) not in ("degraded", "recovered"):
                problems.append(
                    f"{where}: degraded row needs 'subsystem' and a"
                    " 'state' of degraded|recovered"
                )
        elif kind != "meta":
            problems.append(f"{where}: unknown row type {kind!r}")
    return problems


def summarize_rows(rows: list[dict]) -> dict:
    """The aggregate the CLI prints and ``summarize_capture`` publishes."""
    steps = [r for r in rows if r.get("type") == "step"]
    dispatches = [r for r in rows if r.get("type") == "dispatch"]
    final = {}
    if steps:
        final = {k: steps[-1].get(k) for k in REQUIRED_STEP_KEYS}
        final["total_kills"] = steps[-1].get("total_kills")
        final["total_divisions"] = steps[-1].get("total_divisions")
        final["total_spawned"] = steps[-1].get("total_spawned")
        final["total_mutations"] = steps[-1].get("total_mutations")
        if steps[-1].get("tile_occupancy") is not None:
            final["tile_occupancy"] = steps[-1]["tile_occupancy"]
    out = {
        "rows": len(rows),
        "steps": len(steps),
        "dispatches": len(dispatches),
        "phases": phase_quantiles(rows),
        "counters": counter_deltas(rows),
        "final": final,
    }
    tiles = [r["tiles"] for r in dispatches if "tiles" in r]
    if tiles:
        out["tiles"] = max(tiles)
    return out


def format_summary(summary: dict) -> str:
    """Render :func:`summarize_rows` output as an aligned text report."""
    lines = [
        f"rows={summary['rows']} steps={summary['steps']} "
        f"dispatches={summary['dispatches']}"
    ]
    if summary["phases"]:
        lines.append("phase timings (ms):")
        width = max(len(n) for n in summary["phases"])
        lines.append(
            f"  {'phase':<{width}}  {'n':>6}  {'p50':>9}  {'p95':>9}"
            f"  {'max':>9}  {'total':>10}"
        )
        for name, st in summary["phases"].items():
            lines.append(
                f"  {name:<{width}}  {st['n']:>6}  {st['p50_ms']:>9.3f}"
                f"  {st['p95_ms']:>9.3f}  {st['max_ms']:>9.3f}"
                f"  {st['total_ms']:>10.3f}"
            )
    if summary["counters"]:
        lines.append("counter deltas:")
        width = max(len(n) for n in summary["counters"])
        for name, st in summary["counters"].items():
            lines.append(
                f"  {name:<{width}}  {st['first']} -> {st['last']}"
                f"  (+{st['delta']})"
            )
    if summary["final"]:
        fin = summary["final"]
        lines.append(
            f"final step: step={fin.get('step')} alive={fin.get('alive')} "
            f"occupied={fin.get('occupied')} "
            f"mm_mass={fin.get('mm_mass')} cm_mass={fin.get('cm_mass')}"
        )
    return "\n".join(lines)
