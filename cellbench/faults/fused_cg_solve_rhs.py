"""Faults of ``poisson_tpu_torch.ops.fused_cg:fused_cg_solve_rhs``: the fused
body (kernels A and B) driven by ``solvers.pcg.drive``, the answer brought
to the host by ``canvas_to_w64``."""


def frozen_step(monkeypatch):
    """Every iteration body returns its state unchanged."""
    from poisson_tpu_torch.ops import fused_cg

    monkeypatch.setattr(fused_cg, "_make_fused_body",
                        lambda *args, **kwargs: lambda s: s)


def altered_answer(monkeypatch):
    """The host answer scaled by 1.05 at one point, as ``canvas_to_w64``
    returns it."""
    import numpy as np
    from poisson_tpu_torch.ops import fused_cg

    to_host = fused_cg.canvas_to_w64

    def altered(*args, **kwargs):
        w = np.array(to_host(*args, **kwargs))
        w[20, 30] *= 1.05
        return w

    monkeypatch.setattr(fused_cg, "canvas_to_w64", altered)


PLANTS = {"frozen_step": frozen_step, "altered_answer": altered_answer}
