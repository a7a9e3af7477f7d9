"""GL012 fixture: a fleet-scoped module drawing from ONE unsplit threefry
key — the same stream broadcasts to every world of the batch, so the "B
independent worlds" are silently correlated.  The per-world forms
(``keys[w]``, ``prng.split(key)``) right below it stay silent."""
from magicsoup_tpu_torch import fleet  # noqa: F401  (marks the module fleet-scoped)
from magicsoup_tpu_torch.ops import prng


def mutate_fleet(keys, w: int):
    shared = prng.prng_key(0)
    bad = prng.uniform(shared, (4,))  # GL012: shared across worlds
    good = prng.uniform(keys[w], (4,))
    also_good = prng.uniform(prng.split(shared, 4)[w], (4,))
    return bad + good + also_good
