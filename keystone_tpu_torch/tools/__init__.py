"""Developer tooling of the port: the static-verifier dry run over the
bundled pipelines (:mod:`.dryrun`).

Port of ``keystone_tpu/tools/__init__.py``; the reference's other tools
(the linter, trace, plan, calibrate, slo, multichip, fleet_chaos) come with
ROADMAP A.15 and A.17.
"""
