"""Static-analysis layer: the op-tape graph auditor and the convention
linter.

Port of ``dlaf_tpu/analysis/``. The reference audits traced jaxprs; the
port has no traced program, so its graph auditor reads an *eager op
tape*: one real call of a builder, recorded op by op (ATen ops, hand
kernel launches, collective verbs, host reads, step scopes). The rules
and their ids are the reference's:

* :mod:`.depgraph` — the tape (:func:`.depgraph.trace`) and the shared
  dependency vocabulary the structural test pins are written in:
  producers by element range, transitive closures, emission order,
  collectives, host syncs, the per-step scope structure.
* :mod:`.graphcheck` — records every builder of the port (unrolled/scan
  x local/grid x uplo x the knob combinations that change the program)
  on a 2x2 grid of one device and audits the tapes: no rank-varying
  collective schedule (multi-process form), no host sync in a hot path,
  no silent f64->f32 demotion on the native routes, no per-step output
  thrown away, no intermediate beyond a configurable multiple of one
  rank's input bytes.
* :mod:`.lint` — an AST convention linter over ``dlaf_tpu_torch/``:
  config knobs are registered ``Configuration`` fields, metric mutation
  in the hot layers is guarded by ``metrics_active()``, no ``np.*`` on
  tensor parameters in the algorithm layers, host syncs (``.item()``,
  ``.cpu()``, ``.numpy()``, ``.tolist()``, ``synchronize()``,
  ``print``) only at allow-listed sites, and no module of the port
  imports ``jax`` or ``dlaf_tpu``. ``# dlaf: disable=RULE(reason)``
  suppresses a finding on its line; the reason is mandatory.
* ``python -m dlaf_tpu_torch.analysis`` — the gate: runs both, diffs
  against the committed :data:`BASELINE_PATH`, exits 1 on any new
  finding. ``--drill`` runs the seeded-bad must-trip programs
  (:mod:`.drills`) that prove the gate can fail.

This module imports neither torch nor numpy: the linter runs without
them.
"""

from .findings import (Finding, diff_baseline, load_baseline,  # noqa: F401
                       write_baseline)

#: Repo-root-relative path of the committed findings baseline.
BASELINE_PATH = "dlaf_tpu_torch/analysis/baseline.json"
