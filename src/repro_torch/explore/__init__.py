"""``repro_torch.explore`` — the multi-objective front explorer of the port:
``archive`` (dominance math + device-resident Pareto archive), ``nsga``
(the NSGA-II generation loop), ``service`` (the cache-first NSGA backend)
and ``api`` (Problem / Query / Session, re-exported at ``repro_torch.api``).
"""
