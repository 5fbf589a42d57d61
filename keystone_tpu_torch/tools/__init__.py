"""Developer and operator tooling of the port, each ``python -m
keystone_tpu_torch.tools.<name>``: the static-verifier dry run over the
bundled pipelines (:mod:`.dryrun`), the trace summarizer (:mod:`.trace`),
the cost-model calibration CLI (:mod:`.calibrate`), the live-snapshot SLO
renderer (:mod:`.slo`), the capacity planner (:mod:`.plan`), the fleet
chaos drill (:mod:`.fleet_chaos`), the mesh runner and its scaling legs
(:mod:`.multichip`) and the discipline linter (:mod:`.lint`).

Port of ``keystone_tpu/tools/__init__.py``.
"""
