"""VIP caching and the communication-volume library (counterpart of the
JAX package's ``caching/``)."""
from .vip import (
    vip_analytical, vip_analytical_device, vip_simulation,
    vip_proxy_degree_reachable, vip_proxy_num_paths_reachable,
    vip_proxy_degree_1hop, vip_randomwalk,
    argsort_vip, get_lambda_vip_cache, VIP_SCHEMES,
)
from .simulate import simulate_vertex_accesses, evaluate_communication_volume

__all__ = [
    "vip_analytical", "vip_analytical_device", "vip_simulation",
    "vip_proxy_degree_reachable", "vip_proxy_num_paths_reachable",
    "vip_proxy_degree_1hop", "vip_randomwalk",
    "argsort_vip", "get_lambda_vip_cache", "VIP_SCHEMES",
    "simulate_vertex_accesses", "evaluate_communication_volume",
]
