"""
Value objects describing the simulated chemistry and interpreted cell state:
:class:`Molecule`, :class:`Chemistry`, the three domain views
(:class:`CatalyticDomain`, :class:`TransporterDomain`,
:class:`RegulatoryDomain`), :class:`Protein` and :class:`Cell`.

Behavior parity with `python/magicsoup/containers.py` of the reference:
molecule interning is process-global with attribute-mismatch errors and
pickle support, domain/protein dict round-trips use the same ``"C"``/
``"T"``/``"R"`` type tags and spec keys, and :class:`Cell` computes its
expensive views lazily.  The implementation here is declarative — each
view class states its spec fields once and shared helpers derive the
dict round-trip and display strings from that single source.
"""
import warnings
from collections import Counter
from typing import Protocol, TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from magicsoup_tpu_torch.world import World


def _kwargs_repr(obj, names: tuple) -> str:
    """``Cls(a:1,b:'x')``-style repr from attribute names."""
    body = ",".join(f"{n}:{getattr(obj, n)!r}" for n in names)
    return f"{type(obj).__name__}({body})"


def _species_sum(mols: list["Molecule"]) -> str:
    """``"2 A + 1 B"``-style species tally (stoichiometry by repetition)."""
    tally = Counter(str(m) for m in mols)
    return " + ".join(f"{count} {name}" for name, count in tally.items())


class Molecule:
    """
    One molecule species of the simulated world.

    Parameters:
        name: Unique identifier of this molecule species.
        energy: Energy content of 1 mol (J); drives reaction equilibria.
        half_life: Decay half life in time steps
            (see ``World.degrade_molecules``).
        diffusivity: Per-step spread rate over the molecule map — the
            ratio of molecules moving to each of the 8 Moore neighbors
            vs. staying put; 1.0 flattens a pixel over its 3x3
            neighborhood in a single step.
        permeability: Per-step membrane crossing rate — the ratio of
            molecules entering a cell vs. staying outside; 1.0
            equilibrates cell and pixel in a single step.

    Species are interned process-wide by name (reference semantics,
    `containers.py:91-132`): re-constructing a name yields the original
    instance, and conflicting attribute values raise ``ValueError``.
    :meth:`from_name` looks up an existing species.  Conventional units:
    mM, seconds, Joules.
    """

    _registry: dict[str, "Molecule"] = {}
    _fields = ("name", "energy", "half_life", "diffusivity", "permeability")

    def __new__(
        cls,
        name: str,
        energy: float,
        half_life: int = 100_000,
        diffusivity: float = 0.1,
        permeability: float = 0.0,
    ):
        interned = cls._registry.get(name)
        if interned is None:
            twins = [
                k for k in cls._registry if k.lower() == name.lower()
            ]
            if twins:
                warnings.warn(
                    f"Creating new molecule {name}. There are molecules"
                    f" with similar names: {', '.join(twins)}. Give them"
                    " identical names if these are the same molecules."
                )
            interned = super().__new__(cls)
            cls._registry[name] = interned
            return interned
        # the mismatch check must live HERE, not in __init__: unpickling
        # calls __new__ with __getnewargs__ but never __init__, and a
        # conflicting payload must raise rather than silently desync the
        # process-global instance
        interned._verify(
            name=name,
            energy=float(energy),
            half_life=half_life,
            diffusivity=diffusivity,
            permeability=permeability,
        )
        return interned

    def _verify(self, **incoming) -> None:
        for field, val in incoming.items():
            have = getattr(self, field)
            if have != val:
                raise ValueError(
                    f"Trying to instantiate Molecule {incoming['name']}"
                    f" with {field} {val}. But {incoming['name']} already"
                    f" exists with {field} {have}"
                )

    def __init__(
        self,
        name: str,
        energy: float,
        half_life: int = 100_000,
        diffusivity: float = 0.1,
        permeability: float = 0.0,
    ):
        if getattr(self, "_sealed", False):
            # interned instance: __new__ already verified the attributes
            return
        # float() matters: an int energy would break the kinetics energy
        # tensor dtype
        self.name = name
        self.energy = float(energy)
        self.half_life = half_life
        self.diffusivity = diffusivity
        self.permeability = permeability
        self._hash = hash(name)
        self._sealed = True

    @classmethod
    def from_name(cls, name: str) -> "Molecule":
        """Look up an already-defined species by name."""
        try:
            return cls._registry[name]
        except KeyError:
            raise ValueError(f"Molecule {name} was not defined yet") from None

    def __getnewargs__(self):
        # pickle resolves back through __new__, preserving interning
        return tuple(getattr(self, f) for f in self._fields)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return hash(self) == hash(other)

    def __lt__(self, other: "Molecule") -> bool:
        return self.name < other.name

    def __repr__(self) -> str:
        return _kwargs_repr(self, self._fields)

    def __str__(self) -> str:
        return self.name


class Chemistry:
    """
    The closed set of molecules and reactions available in a simulation.

    Parameters:
        molecules: All :class:`Molecule` species of this simulation.
        reactions: ``(substrates, products)`` tuples of molecule lists.
            Reactions are reversible; express a stoichiometric
            coefficient above 1 by repeating the molecule.

    Duplicates (molecules and reactions, the latter compared as unordered
    species tallies) are dropped with order preserved, and a reaction
    naming an unlisted molecule raises.  ``mol_2_idx`` / ``molname_2_idx``
    give each species its tensor column — the ordering every
    :class:`World` array uses.  ``a & b`` merges two chemistries.
    """

    def __init__(
        self,
        molecules: list[Molecule],
        reactions: list[tuple[list[Molecule], list[Molecule]]],
    ):
        defined = set(molecules)
        undefined = {
            mol
            for subs, prods in reactions
            for mol in [*subs, *prods]
            if mol not in defined
        }
        if undefined:
            raise ValueError(
                "These molecules were not defined but are part of some"
                f" reactions: {', '.join(sorted(str(m) for m in undefined))}."
                "Please define all molecules."
            )
        self.molecules = list(dict.fromkeys(molecules))
        seen = dict.fromkeys(
            (tuple(sorted(s)), tuple(sorted(p))) for s, p in reactions
        )
        self.reactions = [(list(s), list(p)) for s, p in seen]
        self.mol_2_idx = {m: i for i, m in enumerate(self.molecules)}
        self.molname_2_idx = {m.name: i for i, m in enumerate(self.molecules)}

    def __and__(self, other: "Chemistry") -> "Chemistry":
        return Chemistry(
            molecules=self.molecules + other.molecules,
            reactions=self.reactions + other.reactions,
        )

    def __repr__(self) -> str:
        return _kwargs_repr(self, ("molecules", "reactions"))


class DomainType(Protocol):
    """Protocol for interpreted domain views"""

    start: int
    end: int

    def to_dict(self) -> dict:
        ...

    @classmethod
    def from_dict(cls, dct: dict) -> "DomainType":
        ...


class _DomainView:
    """
    Shared machinery of the three domain views.  A subclass declares its
    one-letter ``_tag`` and ``_spec`` — the ordered spec-dict fields,
    each marked ``True`` when it holds molecule(s) (serialized by name).
    ``to_dict``/``from_dict`` and ``__repr__`` are derived from that
    declaration, so the serialized schema lives in exactly one place.
    """

    _tag = "?"
    _spec: tuple[tuple[str, bool], ...] = ()

    def _encode(self, value, is_mol: bool):
        if not is_mol:
            return value
        if isinstance(value, Molecule):
            return value.name
        # nested containers (e.g. a reaction's (substrates, products)
        # pair) keep their shape, molecules become names
        return type(value)(self._encode(v, True) for v in value)

    @classmethod
    def _decode(cls, value, is_mol: bool):
        if not is_mol:
            return value
        if isinstance(value, str):
            return Molecule.from_name(name=value)
        return type(value)(cls._decode(v, True) for v in value)

    def to_dict(self) -> dict:
        """Serialize as ``{"type": tag, "spec": {...}}``."""
        spec = {
            field: self._encode(getattr(self, field), is_mol)
            for field, is_mol in self._spec
        }
        spec["start"] = self.start  # type: ignore[attr-defined]
        spec["end"] = self.end  # type: ignore[attr-defined]
        return {"type": self._tag, "spec": spec}

    @classmethod
    def from_dict(cls, dct: dict):
        """Rebuild from a spec dict; molecules are resolved by name."""
        kwargs = {
            field: cls._decode(dct[field], is_mol)
            for field, is_mol in cls._spec
        }
        return cls(start=dct["start"], end=dct["end"], **kwargs)


class CatalyticDomain(_DomainView):
    """
    Interpreted view of a catalytic domain: it couples the protein to one
    reaction of the chemistry.

    Parameters:
        reaction: ``(substrates, products)`` molecule lists.
        km: Michaelis constant of the reaction (mM).
        vmax: Maximal catalytic rate (mmol/s).
        start: First position of the domain on its CDS (0-based).
        end: Position one past the domain's last nucleotide.

    Produced by proteome interpretation (``cell.proteome``), not meant to
    be built by hand.
    """

    _tag = "C"
    _spec = (("reaction", True), ("km", False), ("vmax", False))

    def __init__(
        self,
        reaction: tuple[list[Molecule], list[Molecule]],
        km: float,
        vmax: float,
        start: int,
        end: int,
    ):
        self.substrates, self.products = reaction
        self.km = km
        self.vmax = vmax
        self.start = start
        self.end = end

    @property
    def reaction(self) -> tuple[list[Molecule], list[Molecule]]:
        return (self.substrates, self.products)

    def __repr__(self) -> str:
        lhs = ",".join(str(m) for m in self.substrates)
        rhs = ",".join(str(m) for m in self.products)
        return (
            f"CatalyticDomain({lhs}<->{rhs},Km={self.km:.2e},"
            f"Vmax={self.vmax:.2e})"
        )

    def __str__(self) -> str:
        return (
            f"{_species_sum(self.substrates)} <-> "
            f"{_species_sum(self.products)}"
            f" | Km {self.km:.2e} Vmax {self.vmax:.2e}"
        )


class TransporterDomain(_DomainView):
    """
    Interpreted view of a transporter domain: it moves one species across
    the cell membrane.

    Parameters:
        molecule: The transported species.
        km: Michaelis constant of the transport (mM).
        vmax: Maximal transport rate (mmol/s).
        is_exporter: Orientation of the domain's energetic coupling with
            its protein siblings.
        start: First position of the domain on its CDS.
        end: Position one past the domain's last nucleotide.
    """

    _tag = "T"
    _spec = (("molecule", True), ("km", False), ("vmax", False),
             ("is_exporter", False))

    def __init__(
        self,
        molecule: Molecule,
        km: float,
        vmax: float,
        is_exporter: bool,
        start: int,
        end: int,
    ):
        self.molecule = molecule
        self.km = km
        self.vmax = vmax
        self.is_exporter = is_exporter
        self.start = start
        self.end = end

    def _direction(self) -> str:
        return "exporter" if self.is_exporter else "importer"

    def __repr__(self) -> str:
        return (
            f"TransporterDomain({self.molecule},Km={self.km:.2e},"
            f"Vmax={self.vmax:.2e},{self._direction()})"
        )

    def __str__(self) -> str:
        return (
            f"{self.molecule} {self._direction()}"
            f" | Km {self.km:.2e} Vmax {self.vmax:.2e}"
        )


class RegulatoryDomain(_DomainView):
    """
    Interpreted view of a regulatory domain: it modulates its protein's
    activity in response to an effector species.

    Parameters:
        effector: The species sensed by this domain.
        hill: Hill coefficient (cooperativity of binding).
        km: Effector concentration at half occupation (mM).
        is_inhibiting: Whether occupation slows the protein down
            (otherwise it is required for activity).
        is_transmembrane: Sense the pixel's concentrations instead of
            the cell's internal ones.
        start: First position of the domain on its CDS.
        end: Position one past the domain's last nucleotide.
    """

    _tag = "R"
    _spec = (("effector", True), ("km", False), ("hill", False),
             ("is_inhibiting", False), ("is_transmembrane", False))

    def __init__(
        self,
        effector: Molecule,
        hill: int,
        km: float,
        is_inhibiting: bool,
        is_transmembrane: bool,
        start: int,
        end: int,
    ):
        self.effector = effector
        self.hill = int(hill)
        self.km = km
        self.is_inhibiting = is_inhibiting
        self.is_transmembrane = is_transmembrane
        self.start = start
        self.end = end

    def __repr__(self) -> str:
        where = "transmembrane" if self.is_transmembrane else "cytosolic"
        how = "inhibiting" if self.is_inhibiting else "activating"
        return (
            f"ReceptorDomain({self.effector},Km={self.km:.2e},"
            f"hill={self.hill},{where},{how})"
        )

    def __str__(self) -> str:
        where = "[e]" if self.is_transmembrane else "[i]"
        how = "inhibitor" if self.is_inhibiting else "activator"
        return (
            f"{self.effector}{where} {how}"
            f" | Km {self.km:.2e} Hill {self.hill}"
        )


_DOMAIN_TAGS: dict[str, type] = {
    c._tag: c
    for c in (CatalyticDomain, TransporterDomain, RegulatoryDomain)
}


class Protein:
    """
    Interpreted view of one translated protein.

    Parameters:
        domains: The protein's interpreted domain views.
        cds_start: Start of its coding region.
        cds_end: End of its coding region.
        is_fwd: Strand of the CDS.  Coordinates follow the parsing
            direction, so a reverse-complement CDS maps back to 5'-3'
            coordinates as ``n - cds_start``.
    """

    def __init__(
        self, domains: list[DomainType], cds_start: int, cds_end: int,
        is_fwd: bool,
    ):
        self.domains = domains
        self.n_domains = len(domains)
        self.cds_start = cds_start
        self.cds_end = cds_end
        self.is_fwd = is_fwd

    def to_dict(self) -> dict:
        """Serialize, domains as their tagged dicts."""
        return {
            "domains": [d.to_dict() for d in self.domains],
            "cds_start": self.cds_start,
            "cds_end": self.cds_end,
            "is_fwd": self.is_fwd,
        }

    @classmethod
    def from_dict(cls, dct: dict) -> "Protein":
        """Rebuild from :meth:`to_dict` output; unknown domain type tags
        are skipped."""
        return cls(
            domains=[
                _DOMAIN_TAGS[d["type"]].from_dict(d["spec"])
                for d in dct["domains"]
                if d["type"] in _DOMAIN_TAGS
            ],
            cds_start=dct["cds_start"],
            cds_end=dct["cds_end"],
            is_fwd=dct["is_fwd"],
        )

    def __repr__(self) -> str:
        return _kwargs_repr(self, ("cds_start", "cds_end", "domains"))

    def __str__(self) -> str:
        return " | ".join(str(d).split(" | ")[0] for d in self.domains)


class Cell:
    """
    Lazily-evaluated view of one cell and its surroundings, obtained from
    ``World.get_cell()``.

    Parameters:
        world: Originating :class:`World`.
        genome: The cell's genome string; ``None`` defers to the world
            (token-backed worlds then decode ONLY this cell's row on
            first access instead of exporting the whole population).
        position: ``(x, y)`` pixel on the map.
        idx: The cell's current index.
        label: Free-form origin marker for tracking lineages.
        n_steps_alive: Steps since spawn or the last division.
        n_divisions: Divisions in this cell's ancestry.
        proteome / int_molecules / ext_molecules: Optionally pre-filled;
            otherwise computed on first access (the proteome by
            re-translating the genome, the molecule views from the
            world's cached host snapshots).
    """

    def __init__(
        self,
        world: "World",
        genome: str | None = None,
        position: tuple[int, int] = (-1, -1),
        idx: int = -1,
        label: str = "C",
        n_steps_alive: int = 0,
        n_divisions: int = 0,
        proteome: list[Protein] | None = None,
        int_molecules: np.ndarray | None = None,
        ext_molecules: np.ndarray | None = None,
    ):
        self.world = world
        self._genome = genome
        self.position = position
        self.idx = idx
        self.label = label
        self.n_steps_alive = n_steps_alive
        self.n_divisions = n_divisions
        self._proteome = proteome
        self._int_molecules = int_molecules
        self._ext_molecules = ext_molecules

    @property
    def genome(self) -> str:
        """The genome string (fetched from the world on first access
        when constructed lazily; token-backed worlds decode one row)."""
        if self._genome is None:
            self._genome = self.world.genome_of(self.idx)
        return self._genome

    @genome.setter
    def genome(self, value: str) -> None:
        self._genome = value

    @property
    def int_molecules(self) -> np.ndarray:
        """This cell's intracellular concentrations (one row of
        ``world.cell_molecules``, served from the cached host snapshot —
        a per-cell device fetch would transfer the whole buffer)."""
        if self._int_molecules is None:
            self._int_molecules = self.world._host_cell_molecules()[self.idx]
        return self._int_molecules

    @property
    def ext_molecules(self) -> np.ndarray:
        """The concentrations on this cell's map pixel."""
        if self._ext_molecules is None:
            x, y = self.position
            self._ext_molecules = self.world._host_molecule_map()[:, x, y]
        return self._ext_molecules

    @property
    def proteome(self) -> list[Protein]:
        """Interpreted proteome, re-translated from the genome on first
        access (reference containers.py:697-705)."""
        if self._proteome is None:
            (cdss,) = self.world.genetics.translate_genomes(
                genomes=[self.genome]
            )
            self._proteome = (
                self.world.kinetics.get_proteome(proteome=cdss)
                if cdss
                else []
            )
        return self._proteome

    def __repr__(self) -> str:
        return _kwargs_repr(
            self,
            ("genome", "position", "idx", "label", "n_steps_alive",
             "n_divisions"),
        )
