"""
Deterministic math building blocks, in PyTorch.

Counterpart of :mod:`magicsoup_tpu.ops.detmath`: the same constructions
from the same primitive set (float32 multiply chains, float32 add/sub
trees, float64 multiply and add, integer and bit ops, compares, selects
and dtype conversions), so that the port's deterministic mode gives the
JAX package's bits on the CPU:

- `ipow` — masked square-and-multiply (f32 multiply chain + selects);
- `det_exp` — exp2 split + Horner polynomial evaluated in float64;
- `det_div` — magic-constant seeded Newton reciprocal iterated in float64;
- `tree_reduce`/`sum_axis`/`prod_axis` — fixed binary reduction trees;
  `sum_axis` accumulates in float64.

PyTorch runs these op by op (eager), so no multiply is ever fused into
the add that follows it.

XLA's CPU code flushes subnormal results and operands to zero, and so
does the TPU.  PyTorch does not, so deterministic work on the CPU runs
inside :func:`flush_denormal`: single-threaded, with the CPU's
flush-to-zero and denormals-are-zero bits set (they are per-thread bits,
and ATen's worker threads would not see them).  On a CUDA device there is
no such switch for PyTorch's kernels: there the deterministic mode keeps
subnormals, and matches the JAX package's bits wherever none arises.
"""
import contextlib

import torch

_FTZ_DEPTH = 0


@contextlib.contextmanager
def flush_denormal(device: torch.device | str):
    """Scope in which CPU tensor ops flush subnormals to zero as XLA does
    (a no-op for a CUDA device).  Nests; restores the thread count."""
    global _FTZ_DEPTH
    if torch.device(device).type != "cpu" or _FTZ_DEPTH > 0:
        _FTZ_DEPTH += 1
        try:
            yield
        finally:
            _FTZ_DEPTH -= 1
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    _FTZ_DEPTH += 1
    try:
        yield
    finally:
        _FTZ_DEPTH -= 1
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)

_LOG2E = 1.4426950408889634
# Taylor coefficients of 2^f = exp(f ln2) on f in [-0.5, 0.5]
_EXP2_COEFFS = (
    1.0,
    6.931471805599453e-1,
    2.402265069591007e-1,
    5.550410866482158e-2,
    9.618129107628477e-3,
    1.3333558146428441e-3,
    1.5403530393381606e-4,
    1.525273380405984e-5,
)
_POW_BITS = 7  # supports |n| <= 127; stoichiometries/hill sums stay far below
_F32_MIN_NORMAL = 1.17549435e-38


def ipow(x: torch.Tensor, n: torch.Tensor, nonneg: bool = False) -> torch.Tensor:
    """
    ``x ** n`` for float ``x >= 0`` and integer ``n`` via masked
    square-and-multiply, with ``jnp.power``'s edge semantics on the
    integrator's domain: ``0**0 = 1``, ``0**+n = 0``, ``0**-n = inf``.
    Exponents with ``|n| >= 2**_POW_BITS`` saturate to the limit value
    0/1/inf of ``x**±inf``.  ``nonneg=True`` promises ``n >= 0`` and skips
    the reciprocal of the negative-exponent branch.
    """
    n = n.to(torch.int32)
    absn = n.abs()
    r = torch.ones_like(x)
    xp = x
    for bit in range(_POW_BITS):
        r = torch.where(((absn >> bit) & 1) == 1, r * xp, r)
        if bit < _POW_BITS - 1:
            xp = xp * xp
    huge = torch.where(
        x > 1.0,
        torch.full_like(x, float("inf")),
        torch.where(x == 1.0, torch.ones_like(x), torch.zeros_like(x)),
    )
    r = torch.where(absn >= (1 << _POW_BITS), huge, r)
    if nonneg:
        return r
    return torch.where(n < 0, det_div(torch.ones_like(r), r), r)


def det_exp(x: torch.Tensor) -> torch.Tensor:
    """
    ``exp(x)`` from float64 Horner steps: split ``x·log2(e) = k + f`` with
    integer ``k`` and ``f ∈ [-0.5, 0.5]``, evaluate ``2^f`` by a Horner
    polynomial in float64, and scale by ``2^k`` built by integer bit
    assembly.  Returns float32, saturating to 0/inf exactly where float32
    ``np.exp`` does.
    """
    y = x.to(torch.float64) * _LOG2E
    k = torch.round(y)
    f = y - k
    p = torch.full_like(f, _EXP2_COEFFS[-1])
    for c in _EXP2_COEFFS[-2::-1]:
        p = p * f + c
    # 2^k via f64 exponent-field assembly; the clamp runs in f32 (k is
    # integral, and out-of-range |k| only saturates harder).  NaN -> 0
    # first: a NaN-to-int conversion is platform-defined
    k32 = k.to(torch.float32)
    k32 = torch.where(torch.isnan(k32), torch.zeros_like(k32), k32)
    k32 = torch.clamp(k32, -1022.0, 1023.0)
    ki = k32.to(torch.int64)
    scale = ((ki + 1023) << 52).view(torch.float64)
    out = (p * scale).to(torch.float32)
    # ±inf inputs: f = inf - inf = NaN poisons the polynomial; restore
    # exp(inf) = inf, exp(-inf) = 0
    out = torch.where(x == float("inf"), torch.full_like(out, float("inf")), out)
    out = torch.where(x == float("-inf"), torch.zeros_like(out), out)
    return out


def det_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """
    Float32 division through a float64 Newton reciprocal: the divisor's
    mantissa is extracted by integer bit ops into [1, 2), its reciprocal
    is seeded by the magic-constant bit hack and refined by four Newton
    steps in float64, then rescaled by the exact power of two of the
    divisor's exponent.  Subnormal, zero and non-finite divisors take the
    hardware division, whose IEEE special cases are exact everywhere.
    """
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    bn = b.abs()
    bits = bn.view(torch.int32)
    e = (bits >> 23) - 127  # unbiased exponent (normal bn only)
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    seed = (0x7EF311C3 - m.view(torch.int32)).view(torch.float32)
    m64 = m.to(torch.float64)
    r = seed.to(torch.float64)
    for _ in range(4):
        r = r * (2.0 - m64 * r)
    scale = ((1023 - e.to(torch.int64)) << 52).view(torch.float64)
    q = (a.to(torch.float64) * (r * scale)).to(torch.float32)
    q = torch.where(torch.signbit(b), -q, q)
    ok = (bn >= _F32_MIN_NORMAL) & torch.isfinite(bn)
    return torch.where(ok, q, a / b)


def _pad_pow2(x: torch.Tensor, dim: int, value: float) -> torch.Tensor:
    n = x.shape[dim]
    p = 1 << max(n - 1, 0).bit_length() if n > 1 else 1
    if p == n:
        return x
    shape = list(x.shape)
    shape[dim] = p - n
    return torch.cat([x, x.new_full(shape, value)], dim=dim)


def tree_reduce(x: torch.Tensor, dim: int, op, identity: float) -> torch.Tensor:
    """Reduce one dim with a FIXED binary tree (padded with the exact
    identity element to a power of two): the tree shape of the JAX
    package's ``tree_reduce``, halves combined element by element."""
    dim = dim % x.ndim
    x = _pad_pow2(x, dim, identity)
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = op(x.narrow(dim, 0, h), x.narrow(dim, h, h))
    return x.squeeze(dim)


def sum_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Fixed-tree float sum over one dim, accumulated in float64 (the
    input is padded with zeros first, then converted); returns the input
    dtype."""
    dim = dim % x.ndim
    x = _pad_pow2(x, dim, 0.0)
    return tree_reduce(x.to(torch.float64), dim, torch.add, 0.0).to(x.dtype)


def prod_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Fixed-tree float product over one dim (f32 multiply tree)."""
    return tree_reduce(x, dim, torch.mul, 1.0)


def sum_hw(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing two (spatial) dims via one fixed tree."""
    return sum_axis(x.reshape(x.shape[:-2] + (-1,)), -1)
