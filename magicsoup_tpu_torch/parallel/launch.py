"""
A pool of rank processes driven from one parent: ``n`` children join one
process group (:func:`~magicsoup_tpu_torch.parallel.multihost.initialize`
over TCP on the loopback), build a :class:`~.tiled.Mesh`, and then run
the functions the parent names, all ranks in lockstep, returning each
rank's result.  Tests and the smoke run use it to hold a mesh against one
device within one parent; a user's own run is launched with ``torchrun``
instead.

    with RankPool(2, backend="gloo", device="cpu") as pool:
        out = pool.run("mymodule:classic_lifecycle", seed=11, ...)

``fn`` is ``"module:function"``; it is called as ``fn(mesh, *args,
**kwargs)`` in every rank.  Every wait is bounded: the group's
collectives by ``timeout`` seconds, the children's start and each
:meth:`run` by its own limit; a rank that fails or hangs fails the call
(the traceback of the first failing rank is raised) and the pool is torn
down.  Nothing falls back: a failed rank is never replaced by the
parent, and the backend is never switched.

Children are started with ``python -m magicsoup_tpu_torch.parallel.launch``
and are single-threaded for torch work (the deterministic mode's CPU rule);
the package's directory is put on their ``PYTHONPATH``.
"""
import importlib
import os
import secrets
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Connection, answer_challenge, deliver_challenge
from pathlib import Path

from magicsoup_tpu_torch.util import resolve_device

_ROOT = str(Path(__file__).resolve().parents[2])
#: seconds the children may take to start and join the process group
_START_TIMEOUT = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    """``n`` rank processes joined in one process group; see the module
    notes.  ``env`` adds variables to the children's environment.
    ``device=None`` is the card (each rank's own where there are several;
    ``util.resolve_device``), and without one raises naming
    ``device='cpu'``."""

    def __init__(
        self,
        n: int,
        *,
        backend: str = "gloo",
        device: str | None = None,
        timeout: float = 60.0,
        env: dict | None = None,
    ):
        self.n = int(n)
        self.backend = backend
        self.device = str(resolve_device(device, "RankPool"))
        self.timeout = float(timeout)
        self.env = dict(env or {})
        self._procs: list = []
        self._conns: list = []
        for attempt in range(3):
            try:
                self._start()
                break
            except RuntimeError as exc:
                # the group's port, probed free, can be taken by another
                # process before rank 0 binds it: start again on a new one
                if "address already in use" not in str(exc).lower() or attempt == 2:
                    raise

    def _start(self) -> None:
        key = secrets.token_bytes(16)
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(self.n)
        srv.settimeout(_START_TIMEOUT)
        group_port = _free_port()
        env = dict(os.environ)
        env.update(self.env)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        )
        try:
            for rank in range(self.n):
                env_r = dict(env)
                env_r.update(
                    MS_RANK_POOL=f"127.0.0.1:{srv.getsockname()[1]}",
                    MS_RANK_KEY=key.hex(),
                    MS_RANK=str(rank),
                    MS_WORLD=str(self.n),
                    MS_GROUP=f"127.0.0.1:{group_port}",
                    MS_BACKEND=self.backend,
                    MS_DEVICE=self.device,
                    MS_TIMEOUT=str(self.timeout),
                )
                self._procs.append(
                    subprocess.Popen(
                        [sys.executable, "-m", "magicsoup_tpu_torch.parallel.launch"],
                        env=env_r,
                        stdin=subprocess.DEVNULL,
                    )
                )
            # every child must be let through before any can join the
            # group: the group's rendezvous waits for all ranks
            deadline = time.monotonic() + _START_TIMEOUT
            pending = []
            while len(pending) < self.n:
                srv.settimeout(max(deadline - time.monotonic(), 0.01))
                sock, _ = srv.accept()
                conn = Connection(sock.detach())
                self._conns.append(conn)
                deliver_challenge(conn, key)
                pending.append(conn)
            conns: dict[int, Connection] = {}
            for conn in pending:
                if not conn.poll(max(deadline - time.monotonic(), 0.01)):
                    raise TimeoutError("a rank did not join the process group in time")
                status, rank = conn.recv()
                if status != "ready":
                    raise RuntimeError(f"a rank failed to start:\n{rank}")
                conns[rank] = conn
            self._conns = [conns[r] for r in range(self.n)]
        except BaseException:
            self.close()
            raise
        finally:
            srv.close()

    def run(self, fn: str, *args, timeout: float = 600.0, **kwargs) -> list:
        """Run ``fn(mesh, *args, **kwargs)`` on every rank; returns the
        ranks' results in rank order."""
        if not self._conns:
            raise RuntimeError("the rank pool is closed")
        try:
            for conn in self._conns:
                conn.send((fn, args, kwargs))
            deadline = time.monotonic() + timeout
            results = []
            for rank, conn in enumerate(self._conns):
                if not conn.poll(max(deadline - time.monotonic(), 0.01)):
                    raise TimeoutError(f"rank {rank} did not finish {fn} in {timeout} s")
                status, value = conn.recv()
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed in {fn}:\n{value}")
                results.append(value)
            return results
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stop every child (a clean exit when they are idle, a kill
        otherwise) and wait for them."""
        for conn in self._conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _child() -> None:
    """One rank: join the group, then run what the parent sends."""
    import torch

    torch.set_num_threads(1)
    host, port = os.environ["MS_RANK_POOL"].rsplit(":", 1)
    conn = Connection(socket.create_connection((host, int(port))).detach())
    answer_challenge(conn, bytes.fromhex(os.environ["MS_RANK_KEY"]))
    rank = int(os.environ["MS_RANK"])
    try:
        import torch.distributed as dist

        from magicsoup_tpu_torch.parallel import multihost, tiled

        multihost.initialize(
            os.environ["MS_GROUP"],
            int(os.environ["MS_WORLD"]),
            rank,
            backend=os.environ["MS_BACKEND"],
            timeout=float(os.environ["MS_TIMEOUT"]),
        )
        device = torch.device(os.environ["MS_DEVICE"])
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        mesh = tiled.Mesh(device=device)
    except BaseException:
        conn.send(("failed", traceback.format_exc()))
        raise
    conn.send(("ready", rank))
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                mod, name = fn.split(":")
                result = getattr(importlib.import_module(mod), name)(mesh, *args, **kwargs)
                conn.send(("ok", result))
            except BaseException:
                conn.send(("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child()
