"""The port's dry run (`launch.dryrun`) against the JAX reference's.

One spawned subprocess serves the module: it prints `--list` and runs one
cell of each step kind (train_4k, prefill_32k, decode_32k) of a reduced
llama3.2-3b on the single-pod mesh, each on its own fake process group of
256 ranks (the only process groups opened; none in this process), and
writes the records into pytest's tmp dir.  This process never imports
`repro.launch.dryrun` (its import sets a 512-device XLA flag for the
whole process).

* `cell_list` and `--list` equal the reference's order, built here from
  `repro.configs.ASSIGNED` as the reference builds it: 64 cells.
* Each record keeps the reference's keys (`compile_s` is `step_s`,
  `raw_costs_scanned` is `raw_costs_counted`, `accounting_s` is
  `accounting`: the port runs the step eagerly and counts every layer).
* `argument_bytes` equals the sum of the reference's `ShardingRules` shard
  bytes over the reference's specs on an `AbstractMesh` (16, 16): params
  (W8A8 payloads and scales for prefill and decode), the optimizer state
  (train), the batch and the cache (decode).
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ASSIGNED as REF_ASSIGNED  # noqa: E402
from repro.configs import REGISTRY as REF_REGISTRY  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH = "llama3.2-3b"
REDUCED = dict(d_model=128, d_ff=256, vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=2,
               d_head=32)
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
RENAMED = {"compile_s": "step_s", "raw_costs_scanned": "raw_costs_counted",
           "accounting_s": "accounting"}
# the reference's record keys (src/repro/launch/dryrun.py run_cell, single mesh)
REF_KEYS = {"arch", "shape", "mesh", "precision", "n_devices", "status", "tag", "overrides",
            "compile_s", "memory", "raw_costs_scanned", "accounting_s", "roofline"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes_est"}

_RUNNER = """
import contextlib, io, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
out_dir, arch, reduced, shapes = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), sys.argv[4:]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    dryrun.main(["--list"])
with open(f"{out_dir}/list.txt", "w") as f:
    f.write(buf.getvalue())
cfg = get_config(arch).reduced(**reduced)
for shape in shapes:
    record = dryrun.run_cell(arch, shape, "single", cfg=cfg)
    with open(dryrun.result_path(arch, shape, "single", out_dir=out_dir), "w") as f:
        json.dump(record, f)
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _RUNNER, str(out), ARCH,
                           json.dumps(REDUCED), *SHAPES],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = {s: json.loads((out / f"{ARCH}__{s}__single__fp8.json").read_text())
            for s in SHAPES}
    return recs, (out / "list.txt").read_text()


def _ref_cells():
    """The reference's `cell_list`, built as it builds it."""
    by_size = sorted(REF_ASSIGNED, key=lambda n: REF_ASSIGNED[n].param_count())
    return [(name, shape.name, mesh) for mesh in ("multi", "single") for name in by_size
            for shape in REF_ASSIGNED[name].shapes()]


def test_cell_list_matches_reference(records):
    from repro_torch.launch import dryrun
    cells = _ref_cells()
    assert len(cells) == 64
    assert dryrun.cell_list() == cells
    _, listed = records
    assert [tuple(line.split()) for line in listed.splitlines()] == cells


def test_records_go_under_build_not_benchmarks(tmp_path):
    from repro_torch.launch import dryrun
    assert Path(dryrun.RESULTS_DIR) == ROOT / "build" / "dryrun"
    path = Path(dryrun.result_path(ARCH, "decode_32k", "single", out_dir=str(tmp_path)))
    assert path.parent == tmp_path and path.name == f"{ARCH}__decode_32k__single__fp8.json"


@pytest.mark.parametrize("shape", SHAPES)
def test_records_keep_the_reference_keys(records, shape):
    rec = records[0][shape]
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == {RENAMED.get(k, k) for k in REF_KEYS}
    assert REF_MEMORY <= set(rec["memory"])
    assert rec["n_devices"] == 256 and rec["mesh"] == "single" and rec["precision"] == "fp8"
    assert set(rec["raw_costs_counted"]) >= {"flops", "bytes", "coll", "coll_counts"}
    assert "every layer" in rec["accounting"]
    roof = rec["roofline"]
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    mem = rec["memory"]
    assert mem["peak_bytes_est"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                     + mem["output_bytes"] - mem["alias_bytes"])
    assert min(mem[k] for k in REF_MEMORY) >= 0


def _ref_shard_bytes(shardings, specs) -> int:
    total = 0
    for sh, leaf in zip(jax.tree_util.tree_leaves(shardings), jax.tree_util.tree_leaves(specs)):
        total += math.prod(sh.shard_shape(leaf.shape)) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("shape", SHAPES)
def test_argument_bytes_match_reference_shard_bytes(records, shape):
    from jax.sharding import AbstractMesh

    from repro.core.precision import FULL_FP8_ROLLOUT
    from repro.distributed.sharding import ShardingRules
    from repro.launch import steps as ref_steps
    from repro.optim import AdamWConfig
    from repro.optim import init as opt_init

    cfg = REF_REGISTRY[ARCH].reduced(**REDUCED)
    cell = next(s for s in cfg.shapes() if s.name == shape)
    rules = ShardingRules(AbstractMesh((16, 16), ("data", "model")))
    b_specs = ref_steps.input_specs(cfg, cell)
    if cell.kind == "train":
        p_specs = ref_steps.param_specs(cfg)
        o_specs = jax.eval_shape(lambda p: opt_init(p, AdamWConfig()), p_specs)
        want = (_ref_shard_bytes(rules.params(p_specs), p_specs)
                + _ref_shard_bytes(rules.params(o_specs), o_specs)
                + _ref_shard_bytes(rules.batch_spec(b_specs), b_specs))
    else:
        p_specs = ref_steps.param_specs(cfg, FULL_FP8_ROLLOUT)
        want = _ref_shard_bytes(rules.params(p_specs), p_specs)
        if cell.kind == "prefill":
            want += _ref_shard_bytes(rules.batch_spec(b_specs), b_specs)
        else:
            c_specs = ref_steps.cache_specs(cfg, cell, FULL_FP8_ROLLOUT)
            tokens = b_specs["tokens"]
            want += (_ref_shard_bytes(rules.batch_spec(tokens), tokens)
                     + _ref_shard_bytes(rules.cache_spec(c_specs), c_specs))
    assert records[0][shape]["memory"]["argument_bytes"] == want
