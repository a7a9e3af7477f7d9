"""GL024 fixture: device dispatch launched per rung group (the
R-launches-R-fetches-per-megastep loop the fusion planner deletes)."""
from magicsoup_tpu_torch.fleet import batch  # noqa: F401  (marks the module fleet-scoped)


def step_everything(groups, inputs):
    outs = []
    for group in groups:
        outs.append(batch.fleet_step_program(group.fstate, group.fparams, group.consts, inputs))  # GL024: one launch + fetch per rung group
    return outs
