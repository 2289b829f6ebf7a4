"""Faults of ``poisson_tpu_torch.solvers.pcg:pcg_solve``: the plain body
(``make_pcg_body``, torch ops of ``ops.stencil``) driven eagerly by
``solvers.pcg.drive``, the answer returned by ``run_setup``; in fp64 on
the unscaled system where the mix leaves ``dtype`` and ``scaled`` at their
defaults. ``single_precision`` is the entry run in fp32: the drill that
the cell's limits catch a lower precision in the program's place."""


def frozen_step(monkeypatch):
    """Every iteration body returns its state unchanged."""
    from poisson_tpu_torch.solvers import pcg

    monkeypatch.setattr(pcg, "make_pcg_body",
                        lambda *args, **kwargs: lambda s: s)


def altered_answer(monkeypatch):
    """The returned w scaled by 1.05 at one point, as ``run_setup``
    returns it."""
    from poisson_tpu_torch.solvers import pcg

    solve = pcg.run_setup

    def altered(*args, **kwargs):
        out = solve(*args, **kwargs)
        w = out.w.clone()
        w[20, 30] *= 1.05
        return out._replace(w=w)

    monkeypatch.setattr(pcg, "run_setup", altered)


def single_precision(monkeypatch):
    """The entry run with ``dtype="float32"`` (the scaled system, the
    port's fp32 default), everything else as the mix sends it."""
    import functools

    from poisson_tpu_torch.solvers import pcg

    monkeypatch.setattr(pcg, "pcg_solve",
                        functools.partial(pcg.pcg_solve, dtype="float32"))


PLANTS = {"frozen_step": frozen_step, "altered_answer": altered_answer,
          "single_precision": single_precision}
