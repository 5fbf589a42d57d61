"""Developer and operator tooling of the port, each ``python -m
keystone_tpu_torch.tools.<name>``: the static-verifier dry run over the
bundled pipelines (:mod:`.dryrun`), the trace summarizer (:mod:`.trace`),
the cost-model calibration CLI (:mod:`.calibrate`), the live-snapshot SLO
renderer (:mod:`.slo`), the capacity planner (:mod:`.plan`) and the fleet
chaos drill (:mod:`.fleet_chaos`).

Port of ``keystone_tpu/tools/__init__.py``; the reference's other tools
(the linter, multichip) come with ROADMAP A.17b and A.15.
"""
