"""``launches_per_batch``: the kernels that ran on the card in the traced
sub-window, per batch: the device's kernel records, with the K3 launches
the trace lost added back from the port's counter (layer: host dispatch of
the engine and the model, which makes one launch per kernel)."""


def read(run):
    if run.trace is None or not run.trace.launches:
        return None
    return run.trace.launches / run.trace.batches
