"""
Genome -> parameter path of the port against the JAX package, from one
seed: codon maps, token tables, the genome engine, and the assembled
kinetic parameters (bit-equal in all nine tensors).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import random  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from magicsoup_tpu import mutations as jmut  # noqa: E402
from magicsoup_tpu.examples.wood_ljungdahl import CHEMISTRY as JCHEM  # noqa: E402
from magicsoup_tpu.genetics import Genetics as JGenetics  # noqa: E402
from magicsoup_tpu.kinetics import Kinetics as JKinetics  # noqa: E402
from magicsoup_tpu.ops import params as jparams  # noqa: E402
from magicsoup_tpu_torch import mutations as tmut  # noqa: E402
from magicsoup_tpu_torch.examples.wood_ljungdahl import CHEMISTRY as TCHEM  # noqa: E402
from magicsoup_tpu_torch.genetics import Genetics as TGenetics  # noqa: E402
from magicsoup_tpu_torch.interop import tables_from_numpy  # noqa: E402
from magicsoup_tpu_torch.kinetics import Kinetics as TKinetics  # noqa: E402
from magicsoup_tpu_torch.ops import params as tparams  # noqa: E402
from magicsoup_tpu_torch.util import random_genome  # noqa: E402


def _pair(seed: int):
    jg, tg = JGenetics(seed=seed), TGenetics(seed=seed)
    kw = dict(
        scalar_enc_size=max(jg.one_codon_map.values()),
        vector_enc_size=max(jg.two_codon_map.values()),
        seed=seed + 1,
    )
    return (
        jg,
        tg,
        JKinetics(chemistry=JCHEM, **kw),
        TKinetics(chemistry=TCHEM, device="cpu", **kw),
    )


def _genomes(n: int, seed: int) -> list[str]:
    rng = random.Random(seed)
    return [random_genome(s=500, rng=rng) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 7])
def test_codon_maps_and_token_tables_equal(seed):
    jg, tg, jk, tk = _pair(seed)
    assert jg.domain_types == tg.domain_types
    assert jg.one_codon_map == tg.one_codon_map
    assert jg.two_codon_map == tg.two_codon_map
    for name, a, b in zip(jk.tables._fields, jk.tables, tk.tables):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        assert np.array_equal(a, b.numpy(), equal_nan=True), name


def test_genome_engine_equal():
    jg, tg, _, _ = _pair(3)
    genomes = _genomes(40, 3)
    for a, b in zip(jg.translate_genomes_flat(genomes), tg.translate_genomes_flat(genomes)):
        assert np.array_equal(a, b)
    assert jmut.point_mutations(genomes, p=1e-2, seed=5) == tmut.point_mutations(
        genomes, p=1e-2, seed=5
    )
    pairs = list(zip(genomes[::2], genomes[1::2]))
    assert jmut.recombinations(pairs, p=1e-3, seed=5) == tmut.recombinations(
        pairs, p=1e-3, seed=5
    )


def test_compute_cell_params_bit_equal():
    jg, _, jk, tk = _pair(11)
    pc, prots, doms = jg.translate_genomes_flat(_genomes(64, 11))
    dense, _ = jparams.flat_to_dense(pc, prots, doms, int(pc.max()))
    tdense, _ = tparams.flat_to_dense(pc, prots, doms, int(pc.max()))
    assert np.array_equal(dense, tdense)
    ref = jparams.compute_cell_params(
        jnp.asarray(dense), jk.tables, jnp.asarray(310.0, dtype=jnp.float32)
    )
    tables = tables_from_numpy(
        {k: np.asarray(v) for k, v in jk.tables._asdict().items()}, "cpu"
    )
    out = tparams.compute_cell_params(
        torch.from_numpy(tdense), tables, torch.tensor(310.0)
    )
    for name, a, b in zip(ref._fields, ref, out):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b, equal_nan=True), name


def test_rung_grouped_assembly_bit_equal():
    # 300 cells: the dominant rung is assembled at its own (p, d) and
    # padded out; minority rungs fold into the full-capacity group
    jg, _, jk, tk = _pair(5)
    pc, prots, doms = jg.translate_genomes_flat(_genomes(300, 5))
    for k in (jk, tk):
        k.ensure_capacity(n_cells=512)
        k.set_cell_params_flat(list(range(300)), pc, prots, doms)
    assert jk.max_proteins == tk.max_proteins and jk.max_doms == tk.max_doms
    for name, a, b in zip(jk.params._fields, jk.params, tk.params):
        assert np.array_equal(np.asarray(a), b.numpy(), equal_nan=True), name


def test_kinetics_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TKinetics(chemistry=TCHEM, seed=0)
    k = TKinetics(chemistry=TCHEM, seed=0, device="cpu")
    assert k.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in (*k.tables, *k.params))


def test_row_helpers():
    rows = torch.arange(6 * 2, dtype=torch.float32).reshape(6, 2)
    perm = torch.tensor([1, 3, 4, 0, 2, 5])
    out = tparams.compact_rows(rows, perm, 3)
    assert torch.equal(out[:3], rows[[1, 3, 4]]) and not out[3:].any()
    assert tparams.quantize_rows(200, 256) == 256
    assert tparams.quantize_rows(9000, 16384) == 9216
    assert tparams.pad_pow2(65, minimum=64) == 128
