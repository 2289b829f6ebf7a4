"""Faults of ``poisson_tpu_torch.ops.resident:resident_cg_solve``: kernel R,
the whole solve in one launch (``resident_solve``); on the CPU, where the
drills run, R's plain version, which drives the fused body."""


def frozen_step(monkeypatch):
    """Every iteration body returns its state unchanged (the fused body
    that R's plain version drives)."""
    from poisson_tpu_torch.ops import fused_cg

    monkeypatch.setattr(fused_cg, "_make_fused_body",
                        lambda *args, **kwargs: lambda s: s)


def altered_answer(monkeypatch):
    """R's solution canvas scaled by 1.05 at one point, as
    ``resident_solve`` returns it."""
    from poisson_tpu_torch.ops import resident

    solve = resident.resident_solve

    def altered(*args, **kwargs):
        w, *rest = solve(*args, **kwargs)
        w = w.clone()
        w[resident.HALO + 20, 30] *= 1.05
        return (w, *rest)

    monkeypatch.setattr(resident, "resident_solve", altered)


PLANTS = {"frozen_step": frozen_step, "altered_answer": altered_answer}
