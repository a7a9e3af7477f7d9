"""GL026 fixture: hot stepper-scoped function calling the integrator
kernel directly instead of routing through the backend registry."""
from magicsoup_tpu_torch import stepper  # noqa: F401  (marks the module stepper-scoped)
from magicsoup_tpu_torch.ops.cuda_integrate import integrate_signals_cuda


# graftlint: hot
def step_activity(X, params):
    X1 = integrate_signals_cuda(X, params)  # GL026: direct kernel call in hot path
    return X1
