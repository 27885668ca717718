"""``slow_route_launches.<cells>``: kernels a unit in the traced window from
the multi-launch sources that take every shape no fast route is
instantiated for: the namespaces ``ttnx_cg_mf::`` (B4 and B5 on route
``streamed``), ``ttnx_env::`` (B2, B6 and B8 on route ``staged``) and
``ttnx_gram::`` (B1 on route ``staged``). The fast routes' namespaces
(``ttnx_cg_site::``, ``ttnx_envsite::``, ``ttnx_gramgrid::``) are not
among them. Silent on a trace that holds no kernel."""

SLOW = ("ttnx_cg_mf::", "ttnx_env::", "ttnx_gram::")


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    slow = sum(1 for name, _, _ in run.trace.kernels
               if any(ns in name for ns in SLOW))
    return slow / run.trace.units
