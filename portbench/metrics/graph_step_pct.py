"""graph_step_pct: the share of the traced stretch's steps that ran as
CUDA-graph replays (``gan_tpu_torch.runner.replay`` spans) among all its
steps (replays and ``gan_tpu_torch.step.eager`` spans). A steady epoch
replays every full step and runs each pass's partial tail eagerly
(``loop.epoch_plan``); any lower reading is a recapture or an eager
fallback. None on a device without graphs: a stretch with no device event."""

from portbench import spans


def read(stretch):
    replay, eager = spans.name("runner.replay"), spans.name("step.eager")
    if not stretch.device or replay is None or eager is None:
        return None
    replays, eagers = spans.count(stretch, replay), spans.count(stretch, eager)
    if replays + eagers == 0:
        return None
    return 100.0 * replays / (replays + eagers)
