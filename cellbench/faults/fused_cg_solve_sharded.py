"""Faults of
``poisson_tpu_torch.parallel.fused_sharded:fused_cg_solve_sharded``: the
sharded body (kernels A and B on every shard) driven by
``solvers.pcg.drive``, r's halo ring copied between shards each
iteration, the answer gathered from the shards' owned points."""


def frozen_step(monkeypatch):
    """Every iteration body returns its state unchanged."""
    from poisson_tpu_torch.parallel import fused_sharded

    monkeypatch.setattr(fused_sharded, "_make_sharded_body",
                        lambda *args, **kwargs: lambda s: s)


def altered_answer(monkeypatch):
    """The gathered answer scaled by 1.05 at one point."""
    from poisson_tpu_torch.parallel import fused_sharded

    gather = fused_sharded.gather_owned

    def altered(*args, **kwargs):
        w = gather(*args, **kwargs).clone()
        w[20, 30] *= 1.05
        return w

    monkeypatch.setattr(fused_sharded, "gather_owned", altered)


def exchange_skipped(monkeypatch):
    """The exchange between chips left out: r's halo ring never copied."""
    from poisson_tpu_torch.parallel import fused_sharded

    monkeypatch.setattr(fused_sharded, "exchange_r_halo",
                        lambda *args, **kwargs: None)


PLANTS = {"frozen_step": frozen_step, "altered_answer": altered_answer,
          "exchange_skipped": exchange_skipped}
