"""
Verified checkpoint files with rolling retention.  Counterpart of
:mod:`magicsoup_tpu.guard.checkpoint`: the same format, so for the same
plain-data payload and meta both packages write the same bytes, and each
reads the other's files.

File format (``*.msck``)::

    b"MSCK\\n"                                   magic, 5 bytes
    {"schema": 2, "payload_len": N,
     "sha256": "...", "meta": {...}}\\n           one JSON header line
    <N payload bytes>                            pickle of the object

Every field makes loading refuse bad bytes instead of unpickling garbage
into a live world:

- the magic line rejects arbitrary files handed to the loader,
- ``schema`` rejects checkpoints from an incompatible writer; older
  schemas listed in ``SUPPORTED_SCHEMAS`` load through a typed migration
  chain (schema 1 wrote host-string genome worlds, :func:`_migrate_v1`),
- ``payload_len`` catches truncation before hashing,
- ``sha256`` over the payload catches bit flips,
- only after all checks pass does ``pickle.loads`` run.

Failures raise :class:`~magicsoup_tpu_torch.guard.errors.CheckpointError`
whose ``check`` names the first check that failed.  A port world pickles
its tensors as host numpy and its device as a string, so a checkpoint
written on the card loads anywhere (:func:`~.resume.restore_run` picks
the device).

:class:`CheckpointManager` adds step-indexed file names, retention of the
last ``keep`` snapshots, and a ``load_latest`` that walks back over
corrupt or unreadable snapshots.  Writes go through
:func:`magicsoup_tpu_torch.guard.io.atomic_write_bytes`, so a crash
mid-save never destroys an existing snapshot.
"""
from __future__ import annotations

import hashlib
import json
import pickle
import re
import warnings
from pathlib import Path

from magicsoup_tpu_torch.guard import chaos as _chaos
from magicsoup_tpu_torch.guard.errors import CheckpointError
from magicsoup_tpu_torch.guard.io import atomic_write_bytes

_MAGIC = b"MSCK\n"
#: schema the writer stamps.  2 = device-resident genome era: World
#: pickles carry ``genome_backend`` plus either the packed token store
#: or the host string list.
SCHEMA_VERSION = 2
#: schemas the reader accepts; anything older than SCHEMA_VERSION
#: passes through the typed migration chain in ``_MIGRATIONS``.
SUPPORTED_SCHEMAS = frozenset({1, 2})


def _payload_worlds(obj):
    """Yield every World carried by a checkpoint payload: a bare World,
    a ``guard.resume`` run payload (``{"world": ...}``), or a payload
    nesting one run per world under ``"runs"``."""
    if isinstance(obj, dict):
        if "world" in obj:
            yield obj["world"]
        runs = obj.get("runs")
        if isinstance(runs, (list, tuple)):
            for run in runs:
                if isinstance(run, dict) and "world" in run:
                    yield run["world"]
    elif hasattr(obj, "cell_genomes") and hasattr(obj, "n_cells"):
        yield obj


def _migrate_v1(obj, path):
    """Schema 1 -> 2: schema-1 writers predate the device-resident genome
    store; their worlds pickle genomes as a host ``cell_genomes`` string
    list with no ``genome_backend`` marker.  ``World.__setstate__``
    adopts that layout on unpickle (string backend); the migration
    checks that each world landed in a coherent schema-2 genome layout,
    so a damaged or foreign schema-1 payload fails the typed ``migrate``
    check here instead of deep inside a resume.  Pass
    ``genome_backend="token"`` to :func:`~.resume.restore_run` to
    continue a migrated run on the token backend."""
    for world in _payload_worlds(obj):
        backend = getattr(world, "genome_backend", None)
        if backend not in ("string", "token"):
            raise CheckpointError(
                f"checkpoint {path} failed the migrate check: schema 1 "
                f"world did not normalize to a v2 genome layout "
                f"(genome_backend={backend!r})",
                check="migrate",
                path=path,
            )
        try:
            n = int(world.n_cells)
            n_genomes = len(world.cell_genomes)
        except Exception as exc:  # noqa: BLE001 - typed below
            raise CheckpointError(
                f"checkpoint {path} failed the migrate check: schema 1 "
                f"world's genome state is unreadable: {exc}",
                check="migrate",
                path=path,
            ) from exc
        if n_genomes != n:
            raise CheckpointError(
                f"checkpoint {path} failed the migrate check: schema 1 "
                f"world carries {n_genomes} genomes for n_cells={n}",
                check="migrate",
                path=path,
            )
    return obj


#: schema N -> the migration that lifts a payload to schema N+1
_MIGRATIONS = {1: _migrate_v1}


def _pack(obj, meta: dict | None) -> bytes:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    header = {
        "schema": SCHEMA_VERSION,
        "payload_len": len(payload),
        "sha256": hashlib.sha256(payload).hexdigest(),
        "meta": dict(meta or {}),
    }
    head = json.dumps(header, separators=(",", ":"), sort_keys=True)
    return _MAGIC + head.encode("utf-8") + b"\n" + payload


def write_checkpoint(path, obj, *, meta: dict | None = None) -> Path:
    """Atomically write ``obj`` as a verified checkpoint file."""
    path = Path(path)
    atomic_write_bytes(path, _pack(obj, meta), chaos_site="checkpoint.write")
    return path


def _read_header(path: Path) -> tuple[dict, bytes]:
    try:
        fault = _chaos.site("checkpoint.read")
        if fault is not None:
            raise fault.as_oserror()
        raw = path.read_bytes()
    except FileNotFoundError:
        raise CheckpointError(
            f"checkpoint {path} does not exist", check="truncated", path=path
        ) from None
    except OSError as exc:
        # an EIO/EACCES on the read path is not corruption: surface it
        # as its own typed check so load_latest's walk-back can count it
        # separately from bad bytes
        raise CheckpointError(
            f"checkpoint {path} failed the io check: could not read the "
            f"file: {exc}",
            check="io",
            path=path,
        ) from exc
    if not raw.startswith(_MAGIC):
        raise CheckpointError(
            f"checkpoint {path} failed the magic check: not an MSCK file",
            check="magic",
            path=path,
        )
    body = raw[len(_MAGIC) :]
    nl = body.find(b"\n")
    if nl < 0:
        raise CheckpointError(
            f"checkpoint {path} failed the header check: truncated before "
            "the header line ended",
            check="header",
            path=path,
        )
    try:
        header = json.loads(body[:nl].decode("utf-8"))
        schema = int(header["schema"])
        payload_len = int(header["payload_len"])
        digest = str(header["sha256"])
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as exc:
        raise CheckpointError(
            f"checkpoint {path} failed the header check: {exc}",
            check="header",
            path=path,
        ) from exc
    header["schema"] = schema
    header["payload_len"] = payload_len
    header["sha256"] = digest
    return header, body[nl + 1 :]


def inspect_checkpoint(path) -> dict:
    """Verified header (schema/meta/digest) WITHOUT unpickling the
    payload — safe on untrusted files; listing tools use this."""
    header, _payload = _read_header(Path(path))
    return header


def read_checkpoint(path) -> tuple[object, dict]:
    """Load a checkpoint, verifying magic -> schema -> length -> digest
    BEFORE unpickling.  Returns ``(obj, meta)``."""
    path = Path(path)
    header, payload = _read_header(path)
    schema = header["schema"]
    if schema not in SUPPORTED_SCHEMAS:
        raise CheckpointError(
            f"checkpoint {path} failed the version check: schema "
            f"{schema} not in supported {sorted(SUPPORTED_SCHEMAS)}",
            check="version",
            path=path,
        )
    if len(payload) != header["payload_len"]:
        raise CheckpointError(
            f"checkpoint {path} failed the truncation check: payload is "
            f"{len(payload)} bytes, header promises {header['payload_len']}",
            check="truncated",
            path=path,
        )
    actual = hashlib.sha256(payload).hexdigest()
    if actual != header["sha256"]:
        raise CheckpointError(
            f"checkpoint {path} failed the digest check: payload sha256 "
            f"{actual[:16]}... != header {header['sha256'][:16]}...",
            check="digest",
            path=path,
        )
    try:
        obj = pickle.loads(payload)
    except Exception as exc:  # noqa: BLE001 - surfaced as the typed error
        raise CheckpointError(
            f"checkpoint {path} failed to unpickle after all byte checks "
            f"passed: {exc}",
            check="unpickle",
            path=path,
        ) from exc
    meta = header.get("meta", {})
    if schema != SCHEMA_VERSION:
        for v in range(schema, SCHEMA_VERSION):
            obj = _MIGRATIONS[v](obj, path)
        meta = {**meta, "migrated_from": schema}
    return obj, meta


class CheckpointManager:
    """Step-indexed checkpoint directory with rolling retention.

    Parameters:
        directory: Where the ``<prefix>-<step>.msck`` files live
            (created on first save).
        keep: How many newest snapshots to retain; older ones are
            pruned after each successful save.  ``keep >= 2`` is the
            sane minimum — it is what makes ``load_latest``'s
            walk-backward fallback useful when the newest file is
            corrupt.
        prefix: Filename prefix (several managers can share a dir).
    """

    def __init__(self, directory, *, keep: int = 3, prefix: str = "ckpt"):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        if not re.fullmatch(r"[A-Za-z0-9_.-]+", prefix):
            raise ValueError(f"prefix {prefix!r} must be filename-safe")
        self.directory = Path(directory)
        self.keep = int(keep)
        self.prefix = prefix
        self._pat = re.compile(rf"^{re.escape(prefix)}-(\d+)\.msck$")
        # failure accounting: a degradation policy needs a manager-level
        # view of "saves have been failing" without matching messages
        self.save_failures = 0
        self.consecutive_save_failures = 0
        self.delete_failures = 0
        self.last_save_error: str | None = None
        self._warned_delete = False

    def path_for(self, step: int) -> Path:
        return self.directory / f"{self.prefix}-{int(step):010d}.msck"

    def checkpoints(self) -> list[tuple[int, Path]]:
        """``(step, path)`` pairs, ascending by step."""
        if not self.directory.is_dir():
            return []
        out = []
        for p in self.directory.iterdir():
            m = self._pat.match(p.name)
            if m:
                out.append((int(m.group(1)), p))
        out.sort()
        return out

    def latest(self) -> Path | None:
        cks = self.checkpoints()
        return cks[-1][1] if cks else None

    def save(self, obj, *, step: int, meta: dict | None = None) -> Path:
        """Write ``obj`` at ``step`` and prune beyond ``keep``.

        An ``OSError`` (ENOSPC, EIO, ...) propagates to the caller — the
        atomic-write protocol guarantees no torn file was left behind —
        but is COUNTED first (``save_failures`` /
        ``consecutive_save_failures``), so degradation policies can
        decide "warn and retry next cadence" vs "give up" without
        re-deriving history from exceptions.
        """
        meta = dict(meta or {})
        meta.setdefault("step", int(step))
        try:
            path = write_checkpoint(self.path_for(step), obj, meta=meta)
        except OSError as exc:
            self.save_failures += 1
            self.consecutive_save_failures += 1
            self.last_save_error = f"{type(exc).__name__}: {exc}"
            _chaos.note_counter("checkpoint_save_failures")
            raise
        self.consecutive_save_failures = 0
        self.last_save_error = None
        self.prune()
        return path

    def prune(self) -> list[Path]:
        """Delete all but the newest ``keep`` snapshots; returns the
        removed paths.  Delete failures no longer vanish: each one bumps
        ``delete_failures`` and the shared chaos counter (one warning
        per manager, not per file — retention retries the same victims
        every save)."""
        removed = []
        for _step, p in self.checkpoints()[: -self.keep or None]:
            try:
                fault = _chaos.site("checkpoint.delete")
                if fault is not None:
                    raise fault.as_oserror()
                p.unlink()
            except OSError as exc:
                self.delete_failures += 1
                _chaos.note_counter("checkpoint_delete_failures")
                if not self._warned_delete:
                    self._warned_delete = True
                    warnings.warn(
                        f"checkpoint retention could not delete {p.name}: "
                        f"{exc} (counted; retried next save)"
                    )
                continue
            removed.append(p)
        return removed

    def failure_counters(self) -> dict[str, int]:
        """The manager's failure accounting as one flat dict."""
        return {
            "save_failures": self.save_failures,
            "consecutive_save_failures": self.consecutive_save_failures,
            "delete_failures": self.delete_failures,
        }

    def load(self, path) -> tuple[object, dict]:
        return read_checkpoint(path)

    def load_latest(
        self, *, fallback: bool = True
    ) -> tuple[object, dict, Path]:
        """Load the newest verifiable checkpoint.

        With ``fallback`` (default) a corrupt/truncated/mismatched
        newest file is SKIPPED with a warning and the walk continues
        backward — the retention window is exactly the budget for this.
        Raises :class:`CheckpointError` (``check="none"``) when nothing
        in the directory loads.
        """
        cks = self.checkpoints()
        errors: list[CheckpointError] = []
        for _step, path in reversed(cks):
            try:
                obj, meta = read_checkpoint(path)
            except CheckpointError as exc:
                if not fallback:
                    raise
                errors.append(exc)
                import warnings

                warnings.warn(
                    f"skipping unloadable checkpoint {path.name} "
                    f"(failed check: {exc.check}); falling back to the "
                    "previous snapshot"
                )
                continue
            return obj, meta, path
        detail = "; ".join(f"{e.path}: {e.check}" for e in errors)
        raise CheckpointError(
            f"no loadable checkpoint under {self.directory}"
            + (f" (rejected: {detail})" if detail else " (directory empty)"),
            check="none",
            path=self.directory,
        )
