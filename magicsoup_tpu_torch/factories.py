"""
Genome engineering: generate nucleotide sequences that encode a desired
proteome (the inverse of translation).  Counterpart of
:mod:`magicsoup_tpu.factories` (host code, copied).

Each domain factory picks a random type codon pair of its domain type and
samples tokens through the Kinetics inverse maps (``closest_value`` for
target Km, Vmax and hill); unspecified scalars become random non-stop
codons; :class:`GenomeFact` validates the proteome, wraps each CDS in
start and stop codons and pads with start- and stop-free random sequence
up to ``target_size``.  Every draw comes from ``world._rng`` in the JAX
package's order, so one seed gives the same genome strings in both
packages.
"""
import random
from collections import Counter
from typing import TYPE_CHECKING, Protocol

from magicsoup_tpu_torch.constants import CODON_SIZE
from magicsoup_tpu_torch.containers import Molecule
from magicsoup_tpu_torch.util import closest_value, random_genome

if TYPE_CHECKING:
    from magicsoup_tpu_torch.world import World


class DomainFactType(Protocol):
    """Protocol for domain factories"""

    def validate(self, world: "World"):
        ...

    def gen_coding_sequence(self, world: "World") -> str:
        ...

    @classmethod
    def from_dict(cls, dct: dict) -> "DomainFactType":
        ...


def _scalar_codon(
    world: "World",
    inverse_map: dict,
    target,
    rng: random.Random,
) -> str:
    """Codon for a scalar token: closest mapped value to target, or a random
    non-stop codon if no target given."""
    genetics = world.genetics
    if target is None:
        return random_genome(s=CODON_SIZE, excl=genetics.stop_codons, rng=rng)
    val = closest_value(values=inverse_map, key=target)
    idx = rng.choice(inverse_map[val])
    return genetics.idx_2_one_codon[idx]


def _domain_seq(world: "World", dom_type: int, tok_seqs: list[str]) -> str:
    """Assemble a full domain coding sequence: a random type codon-pair of
    ``dom_type`` followed by the 4 token sequences (Genetics layout:
    2 type codons + 3 scalar codons + 1 two-codon vector token)."""
    type_seq = world._rng.choice(world.genetics.domain_types[dom_type])
    return type_seq + "".join(tok_seqs)


def _opt_parts(*pairs) -> list[str]:
    """``(fmt, value)`` pairs -> formatted strings for the non-None values."""
    return [fmt.format(v) for fmt, v in pairs if v is not None]


def _with_opts(base: str, opts: list[str]) -> str:
    return base if not opts else f"{base} | {' '.join(opts)}"


def _mol_side(mols: list[Molecule]) -> str:
    """``1 A + 2 B`` style summary with per-species counts (count first,
    matching the containers' domain ``__str__`` format)."""
    counts = Counter(str(m) for m in mols)
    return " + ".join(f"{n} {name}" for name, n in counts.items())


class CatalyticDomainFact:
    """
    Factory generating nucleotide sequences encoding a catalytic domain.

    Arguments:
        reaction: ``(substrates, products)`` tuple of the chemistry
            reaction (stoichiometry > 1 = list the molecule repeatedly).
        km: Target Michaelis-Menten constant (mM); closest mapped value is
            used.  Random if ``None``.
        vmax: Target maximum velocity (mM/s); closest mapped value is used.
            Random if ``None``.
    """

    def __init__(
        self,
        reaction: tuple[list[Molecule], list[Molecule]],
        km: float | None = None,
        vmax: float | None = None,
    ):
        substrates, products = reaction
        self.substrates = sorted(substrates)
        self.products = sorted(products)
        self.km = km
        self.vmax = vmax

    def validate(self, world: "World"):
        """Validate this domain factory's attributes against the world"""
        want = (tuple(self.substrates), tuple(self.products))
        known: set[tuple] = set()
        for subs, prods in world.chemistry.reactions:
            fwd = (tuple(sorted(subs)), tuple(sorted(prods)))
            known.add(fwd)
            known.add(fwd[::-1])
        if want not in known:
            lft = " + ".join(d.name for d in self.substrates)
            rgt = " + ".join(d.name for d in self.products)
            raise ValueError(
                f"Cannot encode catalytic domain for {lft} <-> {rgt}:"
                " no such reaction in this world's chemistry"
            )

    def gen_coding_sequence(self, world: "World") -> str:
        """Generate a nucleotide sequence for this domain"""
        # token layout: Vmax | Km | direction | reaction
        kinetics = world.kinetics
        genetics = world.genetics
        rng = world._rng

        react = (tuple(self.substrates), tuple(self.products))
        is_fwd = react in kinetics.catal_2_idxs
        if not is_fwd:
            react = react[::-1]

        toks = [
            _scalar_codon(world, kinetics.vmax_2_idxs, self.vmax, rng),
            _scalar_codon(world, kinetics.km_2_idxs, self.km, rng),
            genetics.idx_2_one_codon[rng.choice(kinetics.sign_2_idxs[is_fwd])],
            genetics.idx_2_two_codon[rng.choice(kinetics.catal_2_idxs[react])],
        ]
        return _domain_seq(world, dom_type=1, tok_seqs=toks)

    @classmethod
    def from_dict(cls, dct: dict) -> "CatalyticDomainFact":
        """Create from a domain dict (``CatalyticDomain.to_dict()``)"""
        dct = dct["spec"]
        subs, prods = dct["reaction"]
        reaction = (
            [Molecule.from_name(d) for d in subs],
            [Molecule.from_name(d) for d in prods],
        )
        return cls(reaction=reaction, km=dct.get("km"), vmax=dct.get("vmax"))

    def __repr__(self) -> str:
        ins = ",".join(str(d) for d in self.substrates)
        outs = ",".join(str(d) for d in self.products)
        opts = _opt_parts(("Km={:.2e}", self.km), ("Vmax={:.2e}", self.vmax))
        return f"CatalyticDomain({','.join([f'{ins}<->{outs}', *opts])})"

    def __str__(self) -> str:
        base = f"{_mol_side(self.substrates)} <-> {_mol_side(self.products)}"
        return _with_opts(
            base, _opt_parts(("Km {:.2e}", self.km), ("Vmax {:.2e}", self.vmax))
        )


class TransporterDomainFact:
    """
    Factory generating nucleotide sequences encoding a transporter domain.

    Arguments:
        molecule: The molecule species to be transported.
        km: Target Michaelis-Menten constant (mM); random if ``None``.
        vmax: Target maximum velocity (mM/s); random if ``None``.
        is_exporter: Energetic coupling direction; random if ``None``.
    """

    def __init__(
        self,
        molecule: Molecule,
        km: float | None = None,
        vmax: float | None = None,
        is_exporter: bool | None = None,
    ):
        self.molecule = molecule
        self.km = km
        self.vmax = vmax
        self.is_exporter = is_exporter

    def validate(self, world: "World"):
        """Validate this domain factory's attributes against the world"""
        if self.molecule not in world.chemistry.molecules:
            raise ValueError(
                f"Cannot encode transporter domain for {self.molecule}:"
                " no such molecule species in this world's chemistry"
            )

    def gen_coding_sequence(self, world: "World") -> str:
        """Generate a nucleotide sequence for this domain"""
        # token layout: Vmax | Km | export direction | molecule
        kinetics = world.kinetics
        genetics = world.genetics
        rng = world._rng

        if self.is_exporter is None:
            dir_seq = random_genome(s=CODON_SIZE, excl=genetics.stop_codons, rng=rng)
        else:
            dir_seq = genetics.idx_2_one_codon[
                rng.choice(kinetics.sign_2_idxs[self.is_exporter])
            ]

        toks = [
            _scalar_codon(world, kinetics.vmax_2_idxs, self.vmax, rng),
            _scalar_codon(world, kinetics.km_2_idxs, self.km, rng),
            dir_seq,
            genetics.idx_2_two_codon[rng.choice(kinetics.trnsp_2_idxs[self.molecule])],
        ]
        return _domain_seq(world, dom_type=2, tok_seqs=toks)

    @classmethod
    def from_dict(cls, dct: dict) -> "TransporterDomainFact":
        """Create from a domain dict (``TransporterDomain.to_dict()``)"""
        dct = dct["spec"]
        return cls(
            molecule=Molecule.from_name(dct["molecule"]),
            km=dct.get("km"),
            vmax=dct.get("vmax"),
            is_exporter=dct.get("is_exporter"),
        )

    def _kind(self) -> str | None:
        if self.is_exporter is None:
            return None
        return "exporter" if self.is_exporter else "importer"

    def __repr__(self) -> str:
        opts = _opt_parts(
            ("Km={:.2e}", self.km),
            ("Vmax={:.2e}", self.vmax),
            ("{}", self._kind()),
        )
        return f"TransporterDomain({','.join([str(self.molecule), *opts])})"

    def __str__(self) -> str:
        base = f"{self.molecule} {self._kind() or 'transporter'}"
        return _with_opts(
            base, _opt_parts(("Km {:.2e}", self.km), ("Vmax {:.2e}", self.vmax))
        )


class RegulatoryDomainFact:
    """
    Factory generating nucleotide sequences encoding a regulatory domain.

    Arguments:
        effector: Effector molecule species.
        is_transmembrane: React to extracellular instead of intracellular
            effector concentrations.
        is_inhibiting: Inhibiting vs. activating; random if ``None``.
        km: Target ligand concentration of half occupation (mM); random if
            ``None``.
        hill: Target hill coefficient (1, 3, 5 available); random if
            ``None``.
    """

    def __init__(
        self,
        effector: Molecule,
        is_transmembrane: bool,
        is_inhibiting: bool | None = None,
        km: float | None = None,
        hill: int | None = None,
    ):
        self.effector = effector
        self.is_transmembrane = is_transmembrane
        self.is_inhibiting = is_inhibiting
        self.km = km
        self.hill = hill

    def validate(self, world: "World"):
        """Validate this domain factory's attributes against the world"""
        if self.effector not in world.chemistry.molecules:
            raise ValueError(
                f"Cannot encode regulatory domain with effector {self.effector}:"
                " no such molecule species in this world's chemistry"
            )

    def gen_coding_sequence(self, world: "World") -> str:
        """Generate a nucleotide sequence for this domain"""
        # token layout: hill | Km | sign (activating=+) | effector
        kinetics = world.kinetics
        genetics = world.genetics
        rng = world._rng

        if self.hill is None:
            hill_seq = random_genome(s=CODON_SIZE, excl=genetics.stop_codons, rng=rng)
        else:
            val = int(closest_value(values=kinetics.hill_2_idxs, key=self.hill))
            hill_seq = genetics.idx_2_one_codon[rng.choice(kinetics.hill_2_idxs[val])]

        if self.is_inhibiting is None:
            sign_seq = random_genome(s=CODON_SIZE, excl=genetics.stop_codons, rng=rng)
        else:
            sign_seq = genetics.idx_2_one_codon[
                rng.choice(kinetics.sign_2_idxs[not self.is_inhibiting])
            ]

        effector_key = (self.effector, self.is_transmembrane)
        toks = [
            hill_seq,
            _scalar_codon(world, kinetics.km_2_idxs, self.km, rng),
            sign_seq,
            genetics.idx_2_two_codon[rng.choice(kinetics.regul_2_idxs[effector_key])],
        ]
        return _domain_seq(world, dom_type=3, tok_seqs=toks)

    @classmethod
    def from_dict(cls, dct: dict) -> "RegulatoryDomainFact":
        """Create from a domain dict (``RegulatoryDomain.to_dict()``)"""
        dct = dct["spec"]
        return cls(
            effector=Molecule.from_name(dct["effector"]),
            km=dct["km"],
            hill=dct.get("hill"),
            is_inhibiting=dct.get("is_inhibiting"),
            is_transmembrane=dct["is_transmembrane"],
        )

    def _mode(self) -> str | None:
        if self.is_inhibiting is None:
            return None
        return "inhibitor" if self.is_inhibiting else "activator"

    def __repr__(self) -> str:
        # same vocabulary as containers.RegulatoryDomain.__repr__
        mode = None
        if self.is_inhibiting is not None:
            mode = "inhibiting" if self.is_inhibiting else "activating"
        opts = _opt_parts(
            ("Km={:.2e}", self.km),
            ("hill={}", self.hill),
            ("{}", "transmembrane" if self.is_transmembrane else "cytosolic"),
            ("{}", mode),
        )
        return f"ReceptorDomain({','.join([str(self.effector), *opts])})"

    def __str__(self) -> str:
        loc = "[e]" if self.is_transmembrane else "[i]"
        base = f"{self.effector}{loc} {self._mode() or 'effector'}"
        return _with_opts(
            base, _opt_parts(("Km {:.2e}", self.km), ("Hill {}", self.hill))
        )


class GenomeFact:
    """
    Factory for generating genomes that translate into a desired proteome.

    Arguments:
        world: :class:`World` in which the genome will be used.
        proteome: Desired proteome as a list (proteins) of lists of domain
            factories.
        target_size: Optional genome size; padded with start/stop-free
            random sequence.  Smallest possible size if ``None``.

    The generated genome always encodes the desired proteins, but larger
    genomes may also encode additional proteins in other reading frames or
    on the reverse-complement.
    """

    def __init__(
        self,
        world: "World",
        proteome: list[list[DomainFactType]],
        target_size: int | None = None,
    ):
        self.world = world
        self.proteome = self._checked(world, proteome)

        per_prot_nts = [
            world.genetics.dom_size * len(doms) + 2 * CODON_SIZE
            for doms in self.proteome
        ]
        self.req_nts = sum(per_prot_nts)
        self.target_size = target_size if target_size is not None else self.req_nts
        if self.target_size < self.req_nts:
            raise ValueError(
                f"target_size={self.target_size} is too small for this"
                f" proteome: its CDSs alone need {self.req_nts} nucleotides"
            )

    @staticmethod
    def _checked(
        world: "World", proteome: list[list[DomainFactType]]
    ) -> list[list[DomainFactType]]:
        if isinstance(proteome, str) or not hasattr(proteome, "__iter__"):
            raise ValueError(
                f"proteome must be a list of proteins, each a list of domain"
                f" factories; got {type(proteome).__name__}"
            )
        for pi, doms in enumerate(proteome):
            if isinstance(doms, str) or not hasattr(doms, "__iter__"):
                raise ValueError(
                    f"proteome must be a list of proteins, each a list of"
                    f" domain factories; protein {pi} is"
                    f" {type(doms).__name__}, not a list"
                )
            for dom in doms:
                dom.validate(world=world)
        return proteome

    def generate(self) -> str:
        """Generate a genome with the desired proteome"""
        world = self.world
        rng = world._rng
        genetics = world.genetics
        # spacers must not open or close reading frames of their own
        non_coding = genetics.start_codons + genetics.stop_codons

        # one spacer before each CDS plus one trailing; spare nts are
        # spread as evenly as integer sizes allow
        n_gaps = len(self.proteome) + 1
        base, extra = divmod(self.target_size - self.req_nts, n_gaps)
        gap_sizes = [base + (1 if i < extra else 0) for i in range(n_gaps)]

        chunks: list[str] = []
        for doms, gap in zip(self.proteome, gap_sizes):
            chunks.append(random_genome(s=gap, excl=non_coding, rng=rng))
            chunks.append(rng.choice(genetics.start_codons))
            chunks.extend(d.gen_coding_sequence(world=world) for d in doms)
            chunks.append(rng.choice(genetics.stop_codons))
        chunks.append(random_genome(s=gap_sizes[-1], excl=non_coding, rng=rng))
        return "".join(chunks)

    @classmethod
    def from_dicts(cls, dcts: list[dict], world: "World") -> "GenomeFact":
        """
        Create a genome factory from protein dict representations
        (``Protein.to_dict()``).
        """
        prots: list[list[DomainFactType]] = []
        fact_types = {
            "C": CatalyticDomainFact,
            "T": TransporterDomainFact,
            "R": RegulatoryDomainFact,
        }
        for prot_dct in dcts:
            doms: list[DomainFactType] = []
            for dom_dct in prot_dct["domains"]:
                fact = fact_types.get(dom_dct["type"])
                if fact is not None:
                    doms.append(fact.from_dict(dom_dct))
            prots.append(doms)
        return GenomeFact(proteome=prots, world=world)
