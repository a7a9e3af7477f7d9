"""
The port's genome factories against the JAX package's: from one seed the
two packages generate the same genome strings, and a generated genome
translates back into the proteome it was made for (the round trips of
``tests/fast/test_factories.py``, on port worlds); ``util.round_down``
and ``util.closest_value`` against the JAX package's.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

import magicsoup_tpu as ms  # noqa: E402
import magicsoup_tpu_torch as mt  # noqa: E402

_NAMES = (("tfact-a", 10e3), ("tfact-b", 8e3), ("tfact-c", 4e3))


def _chemistry(pkg):
    a, b, c = (pkg.Molecule(n, e) for n, e in _NAMES)
    return pkg.Chemistry(molecules=[a, b, c], reactions=[([a], [b]), ([a, b], [c])]), (a, b, c)


def _world(pkg, seed=5, **kw):
    chem, mols = _chemistry(pkg)
    kw = {"device": "cpu", **kw} if pkg is mt else kw
    return pkg.World(chemistry=chem, map_size=16, seed=seed, **kw), mols


def _proteome(pkg, mols):
    a, b, c = mols
    return [
        [pkg.CatalyticDomainFact(reaction=([a], [b]), km=1.0, vmax=2.0)],
        [pkg.TransporterDomainFact(molecule=c, is_exporter=True)],
        [
            pkg.CatalyticDomainFact(reaction=([a, b], [c])),
            pkg.RegulatoryDomainFact(effector=b, is_transmembrane=True, is_inhibiting=True, hill=3),
        ],
        [
            pkg.TransporterDomainFact(molecule=a, km=0.5, vmax=1.0),
            pkg.RegulatoryDomainFact(effector=c, is_transmembrane=False, km=2.0),
        ],
    ]


@pytest.mark.parametrize("d, to", [(7.9, 3), (9.0, 3), (2.5, 3), (-0.5, 3), (17.0, 4)])
def test_util_helpers_match_jax(d, to):
    from magicsoup_tpu import util as jutil
    from magicsoup_tpu_torch import util as tutil

    assert tutil.round_down(d, to=to) == jutil.round_down(d, to=to)
    values = [0.1, 1.0, 2.5, 7.0, 10.0]
    assert tutil.closest_value(values, d) == jutil.closest_value(values, d)


def test_exports_match_the_jax_package():
    for name in ("CatalyticDomainFact", "TransporterDomainFact", "RegulatoryDomainFact", "GenomeFact"):
        assert name in mt.__all__
    assert set(ms.__all__) - set(mt.__all__) == set()


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("target_size", [None, 400])
def test_same_genomes_as_jax_from_one_seed(seed, target_size):
    jw, jmols = _world(ms, seed)
    tw, tmols = _world(mt, seed)
    jfact = ms.GenomeFact(world=jw, proteome=_proteome(ms, jmols), target_size=target_size)
    tfact = mt.GenomeFact(world=tw, proteome=_proteome(mt, tmols), target_size=target_size)
    assert tfact.req_nts == jfact.req_nts
    for _ in range(3):
        assert tfact.generate() == jfact.generate()
    # the world's streams advanced alike
    assert tw._rng.getstate() == jw._rng.getstate()
    for jd, td in zip(_proteome(ms, jmols)[2], _proteome(mt, tmols)[2]):
        assert (repr(td), str(td)) == (repr(jd), str(jd))


def _in_three_tries(check) -> None:
    """``check()`` passing at least once in three tries: random spacers
    can break a CDS, so ``tests/fast/test_factories.py`` allows two
    failures in three as well."""
    for attempt in range(3):
        try:
            check()
            return
        except AssertionError:
            if attempt == 2:
                raise


def _domains(world, genome, kind):
    (proteome,) = world.genetics.translate_genomes(genomes=[genome])
    prots = world.kinetics.get_proteome(proteome=proteome)
    return [d for p in prots for d in p.domains if isinstance(d, kind)]


def test_catalytic_domain_roundtrip():
    world, (a, b, _) = _world(mt)
    fact = mt.GenomeFact(
        world=world, proteome=[[mt.CatalyticDomainFact(reaction=([a], [b]), km=1.0, vmax=2.0)]]
    )
    def check():
        doms = _domains(world, fact.generate(), mt.CatalyticDomain)
        assert any(sorted(d.substrates) == [a] and sorted(d.products) == [b] for d in doms)

    _in_three_tries(check)


def test_transporter_domain_roundtrip():
    world, (_, _, c) = _world(mt, seed=6)
    fact = mt.GenomeFact(
        world=world, proteome=[[mt.TransporterDomainFact(molecule=c, is_exporter=True)]]
    )
    def check():
        doms = _domains(world, fact.generate(), mt.TransporterDomain)
        assert any(d.molecule is c and d.is_exporter for d in doms)

    _in_three_tries(check)


def test_regulatory_domain_roundtrip():
    world, (a, b, _) = _world(mt, seed=7)
    fact = mt.GenomeFact(
        world=world,
        proteome=[
            [
                mt.CatalyticDomainFact(reaction=([a], [b])),
                mt.RegulatoryDomainFact(
                    effector=b, is_transmembrane=True, is_inhibiting=True, hill=3
                ),
            ]
        ],
    )
    def check():
        doms = _domains(world, fact.generate(), mt.RegulatoryDomain)
        assert any(
            d.effector is b and d.is_transmembrane and d.is_inhibiting and d.hill == 3
            for d in doms
        )

    _in_three_tries(check)


def test_genome_fact_target_size():
    world, (a, b, _) = _world(mt, seed=8)
    proteome = [[mt.CatalyticDomainFact(reaction=([a], [b]))]]
    fact = mt.GenomeFact(world=world, proteome=proteome, target_size=300)
    assert fact.req_nts == world.genetics.dom_size + 6
    assert len(fact.generate()) == 300
    with pytest.raises(ValueError):
        mt.GenomeFact(world=world, proteome=proteome, target_size=10)


def test_genome_fact_validates_reaction_and_molecules():
    world, (_, b, c) = _world(mt, seed=9)
    with pytest.raises(ValueError):
        mt.GenomeFact(world=world, proteome=[[mt.CatalyticDomainFact(reaction=([b], [c]))]])
    stranger = mt.Molecule("tfact-stranger", 1e3)
    with pytest.raises(ValueError):
        mt.GenomeFact(world=world, proteome=[[mt.TransporterDomainFact(molecule=stranger)]])
    with pytest.raises(ValueError):
        mt.GenomeFact(world=world, proteome="not a proteome")


def test_genome_fact_from_dicts_builds_proteome():
    world, (a, b, _) = _world(mt, seed=10)
    fact = mt.GenomeFact(
        world=world, proteome=[[mt.CatalyticDomainFact(reaction=([a], [b]), km=1.0, vmax=2.0)]]
    )
    (proteome,) = world.genetics.translate_genomes(genomes=[fact.generate()])
    prots = world.kinetics.get_proteome(proteome=proteome)
    fact2 = mt.GenomeFact.from_dicts([p.to_dict() for p in prots], world=world)
    assert len(fact2.proteome) == len(prots)
    assert sum(len(p) for p in fact2.proteome) == sum(len(p.domains) for p in prots)


@pytest.mark.parametrize("genome_backend", ["string", "token"])
def test_spawned_fact_genome_translates_to_its_spec(genome_backend):
    world, (a, b, c) = _world(mt, seed=11, genome_backend=genome_backend)
    fact = mt.GenomeFact(
        world=world,
        proteome=[
            [mt.CatalyticDomainFact(reaction=([a], [b]), km=1.0, vmax=2.0)],
            [mt.TransporterDomainFact(molecule=c, is_exporter=False)],
        ],
    )
    def check():
        genome = fact.generate()
        (idx,) = world.spawn_cells([genome])
        cell = world.get_cell(by_idx=idx)
        assert cell.genome == genome
        doms = [d for p in cell.proteome for d in p.domains]
        assert any(
            isinstance(d, mt.CatalyticDomain) and sorted(d.substrates) == [a] for d in doms
        )
        assert any(
            isinstance(d, mt.TransporterDomain) and d.molecule is c and not d.is_exporter
            for d in doms
        )

    _in_three_tries(check)
