"""GL023 fixture: host genome list access inside a hot stepper-scoped
function (per-cell device-store decode on the step loop)."""
from magicsoup_tpu_torch import stepper  # noqa: F401  (marks the module stepper-scoped)


# graftlint: hot
def replay_rows(world, rows):
    changed = []
    for r in rows:
        g = world.cell_genomes[r]  # GL023: host genome list load in hot path
        changed.append(len(g))
    return changed
