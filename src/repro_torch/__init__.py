"""TriPoll on PyTorch and CUDA: the static push-pull survey on one GPU.

A port of :mod:`repro` (JAX) that keeps its module layout and names. The
main path is ``HostGraph`` → :func:`core.dodgr.shard_dodgr` →
:func:`core.pushpull.plan_engine` → :func:`core.engine.survey_push_only` /
:func:`core.engine.survey_push_pull` → ``survey.merge`` → ``finalize``,
with all S logical shards stacked on one device, and its epoch-incremental
form: ``HostGraph.append_edges`` → :func:`core.dodgr.shard_delta` →
:func:`core.pushpull.plan_delta` → :func:`core.engine.survey_delta` →
:func:`core.engine.finalize_epochs`; and the long-lived service that
serves both from a plan cache, :class:`serve.SurveyService`.

Device rule: a kernel wrapper takes its plain PyTorch version only for a
tensor on the CPU; for a CUDA tensor it launches the hand-written CUDA
kernel (``csrc/``) or raises. Entry points default to ``device="cuda"``.
"""
