"""Distributed runtime: sharding rules, pipeline parallelism, compression
(port of `repro.distributed`).  The reference's `compat` module is a JAX
API-spelling shim (`shard_map`'s `check_rep` / `check_vma`) with no torch
counterpart."""
from repro_torch.distributed.compression import compressed_pmean, compressed_psum
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply, shard_stages
from repro_torch.distributed.sharding import ShardingRules, safe_spec

__all__ = ["ShardingRules", "safe_spec", "compressed_psum",
           "compressed_pmean", "pipeline_apply", "bubble_fraction", "shard_stages"]
