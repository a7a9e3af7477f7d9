"""
Host-side helper utilities: random sequence generation, codon enumeration,
torus geometry, and the one boundary each way between host and device.

Counterpart of :mod:`magicsoup_tpu.util`, with the same seeded helpers
(every stochastic helper takes an optional ``rng``, a ``random.Random``,
and consumes it exactly as the JAX package does, so seeded worlds match).
The compile-warming scheduler of the JAX package has no role here:
PyTorch runs eagerly and compiles nothing.
"""
import contextlib
import contextvars
import random
import string
import threading
from collections.abc import Iterable
from itertools import product

import numpy as np
import torch

from magicsoup_tpu_torch.constants import ALL_NTS, CODON_SIZE

_DEFAULT_RNG = random.Random()

# 64 URL-safe chars: a power-of-two alphabet makes the byte-mask draw in
# randstr unbiased (256 % 64 == 0), the same C-speed path random_genome uses
_LABEL_CHARS = string.ascii_uppercase + string.ascii_lowercase + string.digits + "-_"
_LABEL_TABLE = bytes(ord(_LABEL_CHARS[b & 63]) for b in range(256))

# template wildcard -> allowed nucleotides; expansion order of each pool is
# what fixes the (token-map-relevant) enumeration order of codons()
_WILDCARDS = {"N": "TCGA", "R": "AG", "Y": "CT"}

# byte -> nucleotide translation table (b & 3 indexes ALL_NTS; 256 % 4 == 0
# keeps the map unbiased): one randbytes + translate per genome
_NT_TABLE = bytes(ord(ALL_NTS[b & 3]) for b in range(256))

_COMPLEMENT = str.maketrans("ACTG", "TGAC")


def round_down(d: float, to: int = 3) -> int:
    """Largest multiple of ``to`` that is <= ``d``"""
    return int(d // to) * to


def closest_value(values: Iterable[float], key: float) -> float:
    """The element of ``values`` nearest to ``key``"""
    return min(values, key=lambda v: abs(v - key))


def randstr(n: int = 12, rng: random.Random | None = None) -> str:
    """Random label string of length ``n`` over 64 characters."""
    rng = rng or _DEFAULT_RNG
    return rng.randbytes(n).translate(_LABEL_TABLE).decode("ascii")


def random_genome(
    s: int = 500, excl: list[str] | None = None, rng: random.Random | None = None
) -> str:
    """
    Random nucleotide sequence of length ``s``.  Sequences in ``excl`` are
    removed (and the genome topped up until it is ``s`` long again); their
    reverse complements may still appear.
    """
    rng = rng or _DEFAULT_RNG

    def draw(k: int) -> str:
        return rng.randbytes(k).translate(_NT_TABLE).decode("ascii")

    if not excl:
        return draw(s)

    def scrub(g: str) -> str:
        for seq in excl:
            g = g.replace(seq, "")
        return g

    out = scrub(draw(s))
    while len(out) < s:
        # appending can create new matches across the seam: re-scrub all
        out = scrub(out + draw(s - len(out)))
    return out


def variants(seq: str) -> list[str]:
    """
    All nucleotide sequences matching a template: ``N`` any nucleotide,
    ``R`` purines (A/G), ``Y`` pyrimidines (C/T).
    """
    pools = [_WILDCARDS.get(c, c) for c in seq]
    return ["".join(chars) for chars in product(*pools)]


def codons(n: int, excl_codons: list[str] | None = None) -> list[str]:
    """
    All sequences of ``n`` codons, optionally excluding sequences that
    contain any codon from ``excl_codons`` at a codon boundary.
    """
    seqs = variants("N" * (n * CODON_SIZE))
    if excl_codons is None:
        return seqs
    banned = set(excl_codons)
    return [
        seq
        for seq in seqs
        if not any(
            seq[a : a + CODON_SIZE] in banned
            for a in range(0, len(seq), CODON_SIZE)
        )
    ]


def reverse_complement(seq: str) -> str:
    """Reverse complement of a DNA sequence (only 'A', 'C', 'T', 'G')"""
    return seq.translate(_COMPLEMENT)[::-1]


def resolve_device(device, owner: str) -> torch.device:
    """The port's device rule: ``None`` means ``"cuda"``, and without a
    CUDA device that is a ``RuntimeError`` naming ``device='cpu'``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{owner}(device=None) runs on CUDA, and no CUDA device is"
                " available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


# the device that objects unpickled in this context are placed on
# (``World.from_file``); unset, each object goes back to the device it was
# saved from
_RESTORE_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "restore_device", default=None
)


@contextlib.contextmanager
def restore_device(device: torch.device):
    """Scope in which unpickled port objects place their tensors on
    ``device`` instead of the device they were saved from."""
    token = _RESTORE_DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _RESTORE_DEVICE.reset(token)


def restored_device(saved: str, owner: str) -> torch.device:
    """Where an unpickled object places its tensors: the device of the
    enclosing :func:`restore_device`, else the one it was saved from; a
    CUDA device that is not there is a ``RuntimeError`` naming
    ``device='cpu'``, never a silent move to the CPU."""
    override = _RESTORE_DEVICE.get()
    if override is not None:
        return override
    device = torch.device(saved)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"this {owner} was saved on {saved!r} and no CUDA device is"
            " available; load it with World.from_file(..., device='cpu')"
        )
    return device


# ------------------------------------------------------------------ #
# the transfer half of analysis.runtime.hot_path_guard               #
# ------------------------------------------------------------------ #
# torch.cuda.set_sync_debug_mode is process-wide (jax.transfer_guard is
# per thread).  Open guards stack the modes they set here, and fetch_host
# lifts the mode to "default" for its own copy while a guard is open, as
# jax.device_get passes a transfer guard.  The lifts are counted under one
# lock, so fetches on two threads (the caller's and a fetcher's) cannot
# restore a stale mode; while any fetch is in flight the mode is "default"
# for the whole process, so another thread's sync then passes unseen.
_SYNC_LOCK = threading.Lock()
_sync_frames: list[int] = []  # the modes the open guards set, innermost last
_sync_base = 0  # the mode found when the outermost guard opened
_sync_lifted = 0  # fetch_host copies in flight under an open guard
_SYNC_MODES = {"default": 0, "warn": 1, "error": 2}


def _sync_wanted() -> int:
    return _sync_frames[-1] if _sync_frames else _sync_base


def push_sync_mode(mode: str | None) -> bool:
    """Open a guard window at sync debug mode ``mode`` (None keeps the
    current one).  Returns whether the window is live: False without a
    CUDA device, where torch's sync debug mode sees nothing."""
    global _sync_base
    if not torch.cuda.is_available():
        return False
    with _SYNC_LOCK:
        if not _sync_frames and _sync_lifted == 0:
            _sync_base = torch.cuda.get_sync_debug_mode()
        target = _sync_wanted() if mode is None else _SYNC_MODES[mode]
        _sync_frames.append(target)
        if _sync_lifted == 0:
            torch.cuda.set_sync_debug_mode(target)
    return True


def pop_sync_mode() -> bool:
    """Close the innermost guard window and restore the mode outside it.
    Returns whether the mode was still the one the window set (a lifted
    fetch in flight counts as such)."""
    with _SYNC_LOCK:
        held = _sync_lifted > 0 or torch.cuda.get_sync_debug_mode() == _sync_frames[-1]
        _sync_frames.pop()
        if _sync_lifted == 0:
            torch.cuda.set_sync_debug_mode(_sync_wanted())
    return held


@contextlib.contextmanager
def sanctioned_sync():
    """Scope of one sanctioned device->host copy (:func:`fetch_host`, the
    token store's pinned snapshots): sync debug mode "default" for it, if
    a guard is open; the open guard's mode again once the last lifted copy
    is done."""
    global _sync_lifted
    with _SYNC_LOCK:
        lift = bool(_sync_frames)
        if lift:
            _sync_lifted += 1
            if _sync_lifted == 1:
                torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if lift:
            with _SYNC_LOCK:
                _sync_lifted -= 1
                if _sync_lifted == 0:
                    torch.cuda.set_sync_debug_mode(_sync_wanted())


def fetch_host(t) -> np.ndarray:
    """Tensor -> host numpy: the port's one device->host boundary.  On a
    CUDA tensor this is a synchronizing copy, allowed inside
    :func:`~magicsoup_tpu_torch.analysis.runtime.hot_path_guard`.  Each
    call is counted in ``telemetry.fetch_stats``."""
    from magicsoup_tpu_torch.telemetry.recorder import note_fetch

    with sanctioned_sync():
        out = t.detach().cpu().numpy()
    note_fetch(out.nbytes)
    return out


def to_device(arr: np.ndarray, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Host numpy -> ``device`` (as ``dtype``), the port's one
    host->device boundary: on a CUDA device through pinned memory without
    blocking the host (a pageable copy would synchronize the stream); on
    the CPU a fresh tensor.  The array is copied first, so the caller may
    change it at once."""
    # order="C": a 0-d array stays 0-d, a strided view becomes contiguous
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if dtype is not None:
        # cast on the host, so what goes up is the pinned tensor itself
        t = t.to(dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


# Background worker threads (the pipelined stepper's record fetcher and
# evolution worker) are daemon threads, so one hung on a device wait never
# blocks process exit; every worker registers here, and one atexit hook
# asks them to stop and joins them with a bounded timeout before teardown.
_EXIT_JOIN_TIMEOUT_S = 60.0
_EXIT_REGISTRY = None


def register_exit_join(worker) -> None:
    """Register ``worker`` (anything with ``exit_join(timeout)``) for the
    stop-and-join at exit."""
    global _EXIT_REGISTRY
    if _EXIT_REGISTRY is None:
        import atexit
        import weakref

        _EXIT_REGISTRY = weakref.WeakSet()

        def _join_all() -> None:
            for w in list(_EXIT_REGISTRY):
                try:
                    w.exit_join(_EXIT_JOIN_TIMEOUT_S)
                except Exception:  # noqa: BLE001 - exit path, best effort
                    pass

        atexit.register(_join_all)
    _EXIT_REGISTRY.add(worker)


def moore_pairs(positions, map_size: int) -> np.ndarray:
    """Unique Moore-adjacent index pairs (smaller first, sorted ascending
    by encoded pair) among ``(k, 2)`` positions on the torus.  The C++
    occupancy-grid scan when the genome engine is built; otherwise the
    vectorized numpy construction below, which gives the same array."""
    positions = np.asarray(positions)
    k = len(positions)
    if k < 2:
        return np.zeros((0, 2), dtype=np.int64)

    from magicsoup_tpu_torch.native import engine as _engine

    native = _engine.neighbor_pairs(positions, map_size)
    if native is not None:
        return native

    m = map_size
    grid = np.full((m, m), -1, dtype=np.int64)
    grid[positions[:, 0], positions[:, 1]] = np.arange(k)
    dx = np.array([-1, -1, -1, 0, 0, 1, 1, 1])
    dy = np.array([-1, 0, 1, -1, 1, -1, 0, 1])
    nx = (positions[:, 0][:, None] + dx[None, :]) % m
    ny = (positions[:, 1][:, None] + dy[None, :]) % m
    cand = grid[nx, ny]
    src = np.broadcast_to(np.arange(k)[:, None], cand.shape)
    # cand != src guards degenerate torus wraps (map_size <= 2)
    valid = (cand >= 0) & (cand != src)
    a, b = src[valid], cand[valid]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    enc = np.unique(lo * np.int64(k) + hi)
    return np.stack([enc // k, enc % k], axis=1)


def dist_1d(a: int, b: int, m: int) -> int:
    """Distance between `a` and `b` on a circular 1D line of size `m`"""
    d0 = abs(a - b)
    return min(d0, m - d0)


def moores_nghbhd(x: int, y: int, map_size: int) -> list[tuple[int, int]]:
    """The 8 wrapped coordinates of the Moore neighborhood on a torus"""
    e = (x + 1) % map_size
    w = (x - 1) % map_size
    s = (y + 1) % map_size
    n = (y - 1) % map_size
    return [(w, n), (w, y), (w, s), (x, n), (x, s), (e, n), (e, y), (e, s)]


def free_moores_nghbhd(
    x: int, y: int, positions: list[tuple[int, int]], map_size: int
) -> list[tuple[int, int]]:
    """Moore neighbors of ``(x, y)`` not occupied per ``positions``."""
    occupied = set(positions)
    return [d for d in moores_nghbhd(x, y, map_size) if d not in occupied]
