"""
The host-side deep audit.  Counterpart of :mod:`magicsoup_tpu.check.audit`.

:func:`audit_world` fetches the device-resident state once (one
``util.fetch_host`` per tensor) and runs the full semantic suite over it:
host/device mirror agreement, occupancy-map consistency, dead-row
residue, concentration sanity, the token store's invariants, and a
sampled genome -> proteome re-translation cross-check against the
assembled kinetic parameters.  The re-translation bypasses the
PhenotypeCache (it calls ``genetics.translate_genomes_flat`` and the
port's ``ops/params.py::compute_cell_params`` directly), so a poisoned
cache entry, a stale push or a corrupted parameter row all surface as the
same typed :class:`InvariantViolation`.

The audit runs on a World that is the source of truth: for pipelined
runs call ``stepper.flush()`` first.  It is read-only.
"""
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class InvariantViolation:
    """One semantic invariant the audited state breaks.

    Attributes:
        code: Stable machine-readable slug (e.g. ``"dead_cm_residue"``,
            ``"params_genome_mismatch"``).
        message: Human-readable description with the observed values.
        rows: Offending cell rows, when the violation is row-local.
        details: Structured extras (counts, maxima) for tooling.
    """

    code: str
    message: str
    rows: tuple = ()
    details: dict = field(default_factory=dict)

    def __str__(self) -> str:  # pragma: no cover - convenience repr
        where = f" rows={list(self.rows)}" if self.rows else ""
        return f"[{self.code}]{where} {self.message}"


class AuditFailed(RuntimeError):
    """Raised by :func:`assert_consistent` when the audit finds
    violations; carries them in ``.violations``."""

    def __init__(self, violations: list[InvariantViolation]):
        lines = "\n".join(f"  - {v}" for v in violations)
        super().__init__(
            f"world audit found {len(violations)} invariant "
            f"violation(s):\n{lines}"
        )
        self.violations = list(violations)


def _sample_rows(n: int, sample: int) -> list[int]:
    """Deterministic, spread-out row sample: both ends plus an even
    stride between them — no RNG, so the audit itself can never fork a
    deterministic trajectory."""
    if n <= sample:
        return list(range(n))
    idx = np.linspace(0, n - 1, num=sample)
    return sorted({int(round(i)) for i in idx})


def audit_world(world, *, sample: int = 8) -> list[InvariantViolation]:
    """Run the full semantic audit; returns typed violations (empty =
    consistent).

    ``sample`` bounds the genome → proteome re-translation cross-check
    (translation is the expensive part); the structural checks always
    cover every row.
    """
    from magicsoup_tpu_torch.guard.sentinel import NEG_EPS
    from magicsoup_tpu_torch.util import fetch_host

    violations: list[InvariantViolation] = []
    n = int(world.n_cells)
    kin = world.kinetics

    # one host fetch per tensor: molecule map, cell molecules, the device
    # position mirror and the nine parameter tensors
    mm = fetch_host(world._molecule_map)
    cm = fetch_host(world._cell_molecules)
    pos_dev = fetch_host(world._positions_dev)
    params = type(kin.params)(*(fetch_host(t) for t in kin.global_params()))
    cap = cm.shape[0]
    m = mm.shape[1]

    # ---- host bookkeeping agrees with itself --------------------------
    genomes = list(world.cell_genomes)
    if len(genomes) != n:
        violations.append(
            InvariantViolation(
                "host_counts",
                f"{len(genomes)} genomes for n_cells={n}",
            )
        )
    if n > cap:
        violations.append(
            InvariantViolation(
                "host_counts",
                f"n_cells={n} exceeds device capacity {cap}",
            )
        )
        n = min(n, cap)

    # ---- token-store invariants (token genome backend only) -----------
    store = getattr(world, "genome_store", None)
    if store is not None:
        violations += _audit_token_store(store, n, sample)

    pos = np.asarray(world.cell_positions)[:n]
    cell_map = np.asarray(world.cell_map)

    # ---- positions: in range, unique, mirrored on device --------------
    if n and (
        (pos < 0).any() or (pos >= m).any()
    ):
        bad = np.nonzero(((pos < 0) | (pos >= m)).any(axis=1))[0]
        violations.append(
            InvariantViolation(
                "pos_out_of_range",
                f"{bad.size} live cells hold positions outside the "
                f"{m}x{m} map",
                rows=tuple(bad[:16].tolist()),
            )
        )
    else:
        lin = pos[:, 0] * m + pos[:, 1]
        uniq, counts = np.unique(lin, return_counts=True)
        if (counts > 1).any():
            dup_lin = set(uniq[counts > 1].tolist())
            rows = [
                i for i, v in enumerate(lin.tolist()) if v in dup_lin
            ]
            violations.append(
                InvariantViolation(
                    "dup_position",
                    f"{len(rows)} live cells share pixels",
                    rows=tuple(rows[:16]),
                )
            )
        if not np.array_equal(pos_dev[:n], pos):
            rows = np.nonzero((pos_dev[:n] != pos).any(axis=1))[0]
            violations.append(
                InvariantViolation(
                    "device_pos_desync",
                    f"device position mirror differs from the host at "
                    f"{rows.size} rows",
                    rows=tuple(rows[:16].tolist()),
                )
            )
        # occupancy map: exactly the live pixels, nothing else
        want = np.zeros((m, m), dtype=bool)
        if n:
            want[pos[:, 0], pos[:, 1]] = True
        if not np.array_equal(cell_map, want):
            extra = int((cell_map & ~want).sum())
            missing = int((~cell_map & want).sum())
            violations.append(
                InvariantViolation(
                    "cell_map_desync",
                    f"occupancy map disagrees with live positions "
                    f"({extra} phantom, {missing} missing pixels)",
                    details={"phantom": extra, "missing": missing},
                )
            )

    # ---- dead-row residue: rows beyond n must be exact zeros ----------
    if (cm[n:] != 0.0).any():
        rows = n + np.nonzero((cm[n:] != 0.0).any(axis=1))[0]
        violations.append(
            InvariantViolation(
                "dead_cm_residue",
                f"{rows.size} dead rows hold nonzero intracellular "
                "concentrations",
                rows=tuple(rows[:16].tolist()),
            )
        )
    dead_param_rows: set[int] = set()
    for leaf in params:
        t = np.asarray(leaf)
        # explicit row width: a full world's tail has no rows, and
        # reshape cannot infer -1 from zero elements
        tail = t[n:].reshape(cap - n, int(np.prod(t.shape[1:])))
        hit = np.nonzero((tail != 0).any(axis=1))[0]
        dead_param_rows.update((n + hit).tolist())
    if dead_param_rows:
        rows = sorted(dead_param_rows)
        violations.append(
            InvariantViolation(
                "dead_param_residue",
                f"{len(rows)} dead rows hold nonzero kinetics "
                "parameters",
                rows=tuple(rows[:16]),
            )
        )

    # ---- concentration sanity (mirrors the stepper's sentinel lanes) --
    if not np.isfinite(mm).all() or (mm < -NEG_EPS).any():
        violations.append(
            InvariantViolation(
                "mm_bad_values",
                "molecule map holds non-finite or negative "
                "concentrations",
            )
        )
    live_cm = cm[:n]
    bad = ~np.isfinite(live_cm).all(axis=1) | (
        live_cm < -NEG_EPS
    ).any(axis=1)
    if bad.any():
        rows = np.nonzero(bad)[0]
        violations.append(
            InvariantViolation(
                "cm_bad_values",
                f"{rows.size} live cells hold non-finite or negative "
                "concentrations",
                rows=tuple(rows[:16].tolist()),
            )
        )

    # ---- sampled genome -> proteome -> params cross-check -------------
    if n and len(genomes) == n and sample > 0:
        violations += _cross_check_params(
            world, params, _sample_rows(n, sample), genomes
        )
    return violations


def _audit_token_store(store, n: int, sample: int) -> list[InvariantViolation]:
    """Packed-token invariants for the device genome store: length
    ranges, PAD discipline beyond each genome and in dead rows, and a
    sampled decode -> re-encode round trip.  These hold by construction
    (every program normalizes PAD past the new length; compaction zeroes
    evicted rows), so any hit means a program or scatter wrote outside
    its mask."""
    from magicsoup_tpu_torch.genomes import PAD, decode_tokens, encode_genomes

    out: list[InvariantViolation] = []
    tok, lens = store.host_arrays()
    tok = np.asarray(tok)
    lens = np.asarray(lens)
    cap, g = tok.shape
    if n > cap:
        out.append(
            InvariantViolation(
                "token_capacity",
                f"n_cells={n} exceeds token store capacity {cap}",
            )
        )
        n = cap
    if (lens < 0).any() or (lens > g).any():
        rows = np.nonzero((lens < 0) | (lens > g))[0]
        out.append(
            InvariantViolation(
                "token_length_range",
                f"{rows.size} rows hold lengths outside [0, {g}]",
                rows=tuple(rows[:16].tolist()),
            )
        )
        return out  # masks below would be nonsense
    col = np.arange(g)
    in_len = col[None, :] < lens[:, None]
    bad_val = in_len & ((tok < 0) | (tok > 3))
    if bad_val.any():
        rows = np.nonzero(bad_val.any(axis=1))[0]
        out.append(
            InvariantViolation(
                "token_range",
                f"{rows.size} rows hold non-nucleotide tokens inside "
                "their genome length",
                rows=tuple(rows[:16].tolist()),
            )
        )
    bad_pad = ~in_len & (tok != PAD)
    if bad_pad.any():
        rows = np.nonzero(bad_pad.any(axis=1))[0]
        out.append(
            InvariantViolation(
                "token_pad_residue",
                f"{rows.size} rows hold non-PAD bytes beyond their "
                "genome length",
                rows=tuple(rows[:16].tolist()),
            )
        )
    if (lens[n:] != 0).any():
        rows = n + np.nonzero(lens[n:] != 0)[0]
        out.append(
            InvariantViolation(
                "token_dead_residue",
                f"{rows.size} dead rows hold nonzero genome lengths",
                rows=tuple(rows[:16].tolist()),
            )
        )
    # sampled decode -> re-encode round trip (codec self-consistency)
    if n and not out:
        rows = _sample_rows(n, sample)
        seqs = decode_tokens(tok[rows], lens[rows])
        re_tok, re_lens = encode_genomes(seqs, length_cap=g)
        if not (
            np.array_equal(re_tok, tok[rows])
            and np.array_equal(re_lens, lens[rows])
        ):
            bad = [
                r
                for k, r in enumerate(rows)
                if not np.array_equal(re_tok[k], tok[r])
            ]
            out.append(
                InvariantViolation(
                    "token_roundtrip",
                    f"{len(bad)} sampled rows fail the decode -> "
                    "re-encode round trip",
                    rows=tuple(bad[:16]),
                )
            )
    return out


def _cross_check_params(
    world, params, rows: list[int], genomes: list[str]
) -> list[InvariantViolation]:
    """Re-translate sampled genomes from scratch and compare the
    full-capacity parameter assembly against the resident rows,
    byte-exact over each cell's REAL protein columns (rung-grouped
    assembly is pinned bit-identical to full-width assembly, so exact
    equality is the contract, not an approximation).  Columns beyond a
    cell's protein count are excluded: they hold either the
    zero-token fill values or exact zeros depending on whether the row
    predates a capacity growth, and both are inert."""
    from magicsoup_tpu_torch.native import engine as _engine
    from magicsoup_tpu_torch.ops.params import compute_cell_params
    from magicsoup_tpu_torch.util import fetch_host, to_device

    kin = world.kinetics
    out: list[InvariantViolation] = []
    pc, prots, doms = world.genetics.translate_genomes_flat(
        [genomes[i] for i in rows]
    )
    need_p = int(pc.max()) if len(pc) else 0
    need_d = (
        int(np.asarray(prots)[:, 3].max()) if len(prots) else 0
    )
    if need_p > kin.max_proteins or need_d > kin.max_doms:
        return [
            InvariantViolation(
                "token_capacity_exceeded",
                f"sampled genomes need (p={need_p}, d={need_d}) tokens "
                f"but capacities are (p={kin.max_proteins}, "
                f"d={kin.max_doms}) — capacities only ever grow, so "
                "genomes and kinetics state are out of sync",
                rows=tuple(rows),
            )
        ]
    dense = _engine.pack_dense(
        pc, prots, doms, kin.max_proteins, max(kin.max_doms, 1)
    )
    expect = compute_cell_params(
        to_device(dense, kin.device), kin.tables, kin._abs_temp_t
    )
    expect = [fetch_host(t) for t in expect]
    names = type(params)._fields
    n_prot = np.asarray(pc, dtype=np.int64)
    bad: dict[int, list[str]] = {}
    for name, have_leaf, want_leaf in zip(names, params, expect):
        have_leaf = np.asarray(have_leaf)
        want_leaf = np.asarray(want_leaf)
        for k, row in enumerate(rows):
            p = int(n_prot[k])
            have = have_leaf[row][:p]
            want = want_leaf[k][:p]
            if have.tobytes() != want.tobytes():
                bad.setdefault(row, []).append(name)
    for row in sorted(bad):
        out.append(
            InvariantViolation(
                "params_genome_mismatch",
                f"cell {row}: resident kinetics params differ from the "
                f"genome's re-translation in {', '.join(bad[row])}",
                rows=(row,),
                details={"tensors": bad[row]},
            )
        )
    return out


def assert_consistent(world, *, sample: int = 8) -> None:
    """:func:`audit_world`, raising :class:`AuditFailed` on any
    violation."""
    violations = audit_world(world, sample=sample)
    if violations:
        raise AuditFailed(violations)
