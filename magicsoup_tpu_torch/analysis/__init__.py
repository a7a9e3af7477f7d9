"""
graftlint for the PyTorch/CUDA port — static analysis and runtime guards
for the card's hot path.  Counterpart of :mod:`magicsoup_tpu.analysis`.

The classes of bug that quietly destroy accelerator throughput (implicit
device->host syncs, dtype drift off the float32 contract, hidden
nondeterminism) are invisible to normal tests: the code still computes the
right numbers, just slower or unreproducibly.  This package enforces them
mechanically:

- static half: an AST lint pass over the port (`engine`, `callgraph`,
  `rules`, `dataflow`, `concurrency`, `sarif`) with a CLI
  (``python -m magicsoup_tpu_torch.analysis --check``); stdlib only, it
  imports neither torch nor the library under analysis;
- runtime half (`runtime`): ``hot_path_guard`` wraps a hot-path window in
  ``torch.cuda.set_sync_debug_mode("error")`` plus a compile budget, and
  ``ownership`` asserts the thread roles the concurrency rules model.

Rule codes: ``python -m magicsoup_tpu_torch.analysis --list-rules``.
Suppress a finding on one line with ``# graftlint: disable=GL001 <why>``
(or a comma list, or ``disable=all``); mark extra hot-path roots for the
reachability analysis with ``# graftlint: hot`` on a ``def`` line.
"""
from magicsoup_tpu_torch.analysis.engine import Finding, analyze  # noqa: F401
