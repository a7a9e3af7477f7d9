"""
Combined CO2-fixation chemistry: six natural carbon-fixation pathways
sharing their intermediates, so cells can evolve any mixture of them
(parity with `python/magicsoup/examples/co2_fixing.py:1-422`, after
Gong, Cai & Li (2016), *Synthetic biology for CO2 fixation*):

- Calvin cycle
- Wood-Ljungdahl pathway
- 3-hydroxypropionate bicycle
- reductive TCA cycle
- dicarboxylate/4-hydroxybutyrate cycle
- 3-hydroxypropionate/4-hydroxybutyrate cycle

Conventions (reference docstring, `examples/co2_fixing.py:108-146`):

- NADPH is the representative electron donor (no FADH2/ferredoxin) and
  ATP->ADP the representative phosphate donor; reactions are defined
  without them unless the coupling is biologically essential.
- ``X`` captures biologically available carbon (selection currency),
  ``E`` replenishes the energy carriers.
- Energies were derived by the reference author from per-molecule P/C/bond
  counts, then iteratively adjusted toward published reaction energies
  (methodology at `examples/co2_fixing.py:120-146`); values here match.
"""
from magicsoup_tpu_torch.containers import Chemistry, Molecule

# name -> (energy [kJ/mol], extra kwargs); gases diffuse and permeate freely
_MOLECULE_DEFS: dict[str, tuple[float, dict]] = {
    # common / carriers
    "CO2": (10.0, {"diffusivity": 1.0, "permeability": 1.0}),
    "NADPH": (200.0, {}),
    "NADP": (130.0, {}),
    "ATP": (100.0, {}),
    "ADP": (65.0, {}),
    "G3P": (420.0, {}),
    "acetyl-CoA": (475.0, {}),
    "HS-CoA": (190.0, {}),
    "pyruvate": (330.0, {}),
    "X": (50.0, {}),
    "E": (150.0, {}),
    # Calvin cycle
    "RuBP": (725.0, {}),
    "3PGA": (350.0, {}),
    "1,3BPG": (370.0, {}),
    "Ru5P": (695.0, {}),
    # Wood-Ljungdahl
    "methyl-FH4": (410.0, {}),
    "methylen-FH4": (355.0, {}),
    "formyl-FH4": (295.0, {}),
    "FH4": (200.0, {}),
    "formate": (70.0, {}),
    "CO": (75.0, {"diffusivity": 1.0, "permeability": 1.0}),
    # 3-hydroxypropionate bicycle
    "malonyl-CoA": (495.0, {}),
    "propionyl-CoA": (675.0, {}),
    "methylmalonyl-CoA": (685.0, {}),
    "succinyl-CoA": (685.0, {}),
    "succinate": (485.0, {}),
    "fumarate": (415.0, {}),
    "malate": (415.0, {}),
    "malyl-CoA": (615.0, {}),
    "glyoxylate": (140.0, {}),
    "methylmalyl-CoA": (810.0, {}),
    "citramalyl-CoA": (810.0, {}),
    # reductive TCA
    "oxalacetate": (350.0, {}),
    "alpha-ketoglutarate": (540.0, {}),
    "isocitrate": (600.0, {}),
    "citrate": (600.0, {}),
    # dicarboxylate/4-hydroxybutyrate
    "PEP": (350.0, {}),
    "SSA": (535.0, {}),  # succinic semialdehyde
    "GHB": (600.0, {}),  # 4-hydroxy-butyrate
    "hydroxybutyryl-CoA": (825.0, {}),
    "acetoacetyl-CoA": (760.0, {}),
}

# (substrate names, product names); stoichiometry > 1 = repeated name.
# Approximate reaction energies in kJ/mol as end-of-line comments.
_REACTION_DEFS: list[tuple[list[str], list[str]]] = [
    # --- common: energy carriers and carbon/energy currencies
    (["NADPH"], ["NADP"]),  # -70
    (["ATP"], ["ADP"]),  # -35
    (["ADP", "ADP", "E"], ["ATP", "ATP"]),  # -80, practically irreversible
    (["NADP", "E"], ["NADPH"]),  # -80, practically irreversible
    (["G3P"], ["X"] * 8),  # -20
    (["pyruvate"], ["X"] * 6),  # -30
    (["acetyl-CoA"], ["HS-CoA"] + ["X"] * 5),  # -35
    # --- Calvin cycle
    (["RuBP", "CO2"], ["3PGA", "3PGA"]),  # -35
    (["3PGA", "ATP"], ["1,3BPG", "ADP"]),  # -15
    (["1,3BPG", "NADPH"], ["G3P", "NADP"]),  # -20
    (["G3P"] * 5, ["Ru5P"] * 3),  # -15
    (["Ru5P", "ATP"], ["RuBP", "ADP"]),  # -5
    # --- Wood-Ljungdahl (methyl + carbonyl branch)
    (["CO2", "NADPH"], ["formate", "NADP"]),  # -10
    (["formate", "FH4"], ["formyl-FH4"]),  # -10
    (["formyl-FH4", "NADPH"], ["methylen-FH4", "NADP"]),  # -10
    (["methylen-FH4", "NADPH"], ["methyl-FH4", "NADP"]),  # -15
    (["CO2", "NADPH"], ["CO", "NADP"]),  # -5
    (["methyl-FH4", "CO", "HS-CoA"], ["acetyl-CoA", "FH4"]),  # 0
    # --- 3-hydroxypropionate bicycle
    (["acetyl-CoA", "CO2"], ["malonyl-CoA"]),  # +10
    (
        ["malonyl-CoA", "NADPH", "NADPH", "NADPH"],
        ["propionyl-CoA", "NADP", "NADP", "NADP"],
    ),  # -30
    (["propionyl-CoA", "CO2"], ["methylmalonyl-CoA"]),  # 0
    (["methylmalonyl-CoA"], ["succinyl-CoA"]),  # 0
    (["succinyl-CoA"], ["succinate", "HS-CoA"]),  # -10
    (["succinate", "NADP"], ["fumarate", "NADPH"]),  # 0
    (["fumarate"], ["malate"]),  # 0
    (["malate", "HS-CoA"], ["malyl-CoA"]),  # +10
    (["malyl-CoA"], ["acetyl-CoA", "glyoxylate"]),  # 0
    (["propionyl-CoA", "glyoxylate"], ["methylmalyl-CoA"]),  # -5
    (["methylmalyl-CoA"], ["citramalyl-CoA"]),  # 0
    (["citramalyl-CoA"], ["acetyl-CoA", "pyruvate"]),  # -5
    # --- reductive TCA
    (["oxalacetate", "NADPH"], ["malate", "NADP"]),  # -5
    (["malate"], ["fumarate"]),  # 0
    (["fumarate", "NADPH"], ["succinate", "NADP"]),  # 0
    (["succinate", "HS-CoA"], ["succinyl-CoA"]),  # +10
    (
        ["succinyl-CoA", "NADPH", "CO2"],
        ["alpha-ketoglutarate", "HS-CoA", "NADP"],
    ),  # -35
    (["alpha-ketoglutarate", "CO2", "NADPH"], ["isocitrate", "NADP"]),  # -20
    (["isocitrate"], ["citrate"]),  # 0
    (["citrate", "HS-CoA"], ["oxalacetate", "acetyl-CoA"]),  # +35
    # --- dicarboxylate/4-hydroxybutyrate cycle
    (["acetyl-CoA", "CO2", "NADPH"], ["pyruvate", "HS-CoA", "NADP"]),  # -35
    (["pyruvate", "ATP"], ["PEP", "ADP"]),  # -15
    (["PEP", "CO2"], ["oxalacetate"]),  # -10
    (["succinyl-CoA", "NADPH"], ["SSA", "HS-CoA", "NADP"]),  # -30
    (["SSA", "NADPH"], ["GHB", "NADP"]),  # -5
    (["GHB", "HS-CoA"], ["hydroxybutyryl-CoA"]),  # +35
    (["hydroxybutyryl-CoA", "NADP"], ["acetoacetyl-CoA", "NADPH"]),  # +5
    (["acetoacetyl-CoA", "HS-CoA"], ["acetyl-CoA", "acetyl-CoA"]),  # 0
    # (the remaining dicarboxylate/4HB and 3HP/4HB steps are shared with
    # the pathways above; Chemistry dedupes repeated definitions)
]

MOLECULES = [
    Molecule(name, energy * 1e3, **kwargs)
    for name, (energy, kwargs) in _MOLECULE_DEFS.items()
]

_BY_NAME = {m.name: m for m in MOLECULES}

REACTIONS = [
    ([_BY_NAME[s] for s in subs], [_BY_NAME[p] for p in prods])
    for subs, prods in _REACTION_DEFS
]

CHEMISTRY = Chemistry(molecules=MOLECULES, reactions=REACTIONS)
