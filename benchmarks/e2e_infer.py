"""End-to-end inference benchmark on the real accelerator.

64 taxa x 2000 sites with 2% missing cells (N): write a FASTA, run the full
CLI `infer` pipeline (stepwise-addition start -> SPR hill climb -> parsimony
ratchet), then the ML pipeline (NJ start -> NNI likelihood climb -> GTR+G
model fit), and report wall time plus unrooted RF distance to the generating
topology (0 = exact recovery). H100 times: not measured yet.

Run: python benchmarks/e2e_infer.py   (one JAX process per card; never run
two GPU jobs on one card at once)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax, jax.numpy as jnp
from trex_tpu.models.mutation_tree import generate_groundtruth
from trex_tpu.topology import topology_from_adjacency
from trex_tpu.io import write_fasta, DNA, load_newick
from trex_tpu.search.ratchet import rf_distance_unrooted
from trex_tpu.cli import main
import io as _io, contextlib

print("backend:", jax.default_backend(), flush=True)
n = 64
data = generate_groundtruth(n_leaves=n, n_states=4, n_mutations=10, seq_length=2000, seed=5)
true = topology_from_adjacency(data.adjacency, n)
seqs = np.asarray(data.masked_sequences[:n])
rng = np.random.default_rng(0)
fasta = write_fasta([f"t{i}" for i in range(n)], seqs, DNA)
# knock out 2% of cells as N
lines = fasta.splitlines()
for i in range(1, len(lines), 2):
    chars = list(lines[i])
    for j in rng.choice(len(chars), size=len(chars)//50, replace=False):
        chars[j] = "N"
    lines[i] = "".join(chars)
open("/tmp/e2e.fasta","w").write("\n".join(lines) + "\n")

t0 = time.perf_counter()
buf = _io.StringIO()
with contextlib.redirect_stdout(buf):
    main(["infer","--fasta","/tmp/e2e.fasta","--start","stepwise","--orders","2",
          "--neighborhood","spr-scan","--ratchet","3","--rounds","40",
          "--output-tree","/tmp/e2e.nwk"])
dt = time.perf_counter() - t0
r = json.loads(buf.getvalue())
got, _, names = load_newick(open("/tmp/e2e.nwk").read())
# reorder leaves by name to match t0..t63
from trex_tpu.io import align_leaf_order
got = align_leaf_order(got, names, [f"t{i}" for i in range(n)])
print(json.dumps({
    "wall_s": round(dt,1), "score": r["parsimony_score"],
    "evals": r["evaluations"], "patterns": r["unique_patterns"],
    "rf_to_truth": rf_distance_unrooted(got, true),
}), flush=True)

# ML on the same data (smaller budget)
t0 = time.perf_counter()
buf = _io.StringIO()
with contextlib.redirect_stdout(buf):
    main(["infer","--fasta","/tmp/e2e.fasta","--start","nj","--criterion","ml",
          "--model","gtr+g","--neighborhood","spr-scan","--rounds","10",
          "--output-tree","/tmp/e2e_ml.nwk"])
dt = time.perf_counter() - t0
r = json.loads(buf.getvalue())
got_ml, _, names_ml = load_newick(open("/tmp/e2e_ml.nwk").read())
got_ml = align_leaf_order(got_ml, names_ml, [f"t{i}" for i in range(n)])
print(json.dumps({
    "ml_wall_s": round(dt,1), "nll": round(r["neg_log_likelihood"],1),
    "gamma_shape": round(r.get("gamma_shape",0),3),
    "ml_rf_to_truth": rf_distance_unrooted(got_ml, true),
}), flush=True)
