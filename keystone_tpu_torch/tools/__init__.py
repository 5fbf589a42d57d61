"""Developer and operator tooling of the port, each ``python -m
keystone_tpu_torch.tools.<name>``: the static-verifier dry run over the
bundled pipelines (:mod:`.dryrun`), the trace summarizer (:mod:`.trace`),
the cost-model calibration CLI (:mod:`.calibrate`), the live-snapshot SLO
renderer (:mod:`.slo`) and the capacity planner (:mod:`.plan`).

Port of ``keystone_tpu/tools/__init__.py``; the reference's other tools
(the linter, multichip, fleet_chaos) come with ROADMAP A.17b, A.15 and
A.16d.
"""
