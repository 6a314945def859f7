"""The tuner of the port: calibration, candidates, selection, the planner
service and the serving planner.

The port's copy of ``repro.tuner``, which picks a collective's schedule
as a function of the machine's (α, β) and the size vector (the paper's
crossover):

* :mod:`~repro_torch.tuner.calibrate` — fit (α, β) per mesh axis from
  exchange micro-measurements (``MeshTimingBackend`` times the port's
  ``mesh.ppermute``; deterministic synthetic backends for device-free
  tests), plus the online refit loop;
* :mod:`~repro_torch.tuner.candidates` — the schedule space behind one
  :class:`Candidate` interface, its dataplane view lowered through the
  port's own planners;
* :mod:`~repro_torch.tuner.select` — model-guided argmin with optional
  measured racing and hysteresis;
* :mod:`~repro_torch.tuner.cache` — the persistent, versioned, LRU plan
  cache and its keys (``mesh_fingerprint`` of the port's meshes);
* :mod:`~repro_torch.tuner.service` — :class:`PlannerService`, the six
  ops' serving front end (plan cache, per-plan executors captured as CUDA
  graphs on one card, telemetry, drift refits and link health), and the
  ``RaggedGathervPlanner`` shim over it in ``core.torch_collectives``;
* :mod:`~repro_torch.tuner.classifier` / :mod:`~repro_torch.tuner.serving`
  — the decode-time layer: raw per-step size vectors map onto bounded
  padded signature classes, predicted next classes are planned (and
  their executors built) off the hot path, and the steady-state serving
  loop builds no new plan or executor.
"""
from .cache import (CACHE_VERSION, PlanCache, PlanKey,  # noqa: F401
                    mesh_fingerprint, quantize_matrix, quantize_sizes)
from .classifier import SignatureClassifier  # noqa: F401
from .calibrate import (Calibration, HierarchicalCalibration,  # noqa: F401
                        HierarchicalOnlineCalibrator, MeshTimingBackend,
                        OnlineCalibrator, SyntheticHierarchicalBackend,
                        SyntheticTimingBackend, calibrate, calibrate_axes,
                        fit_alpha_beta, flat_weights, hierarchical_weights)
from .candidates import (Candidate, OPS,  # noqa: F401
                         enumerate_candidates, plan_pipeline_cost,
                         plan_step_cost)
from .select import Selection, argmin_name, select  # noqa: F401
from .service import PlanRecord, PlannerService  # noqa: F401
from .serving import ServingPlanner, SignaturePredictor  # noqa: F401
