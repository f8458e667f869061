"""The dispatching thread's share of the batch wall, in %, spent in the
host features and their upload: the benchmark's span around
alignment/api.py::_upload_pair_features on the thread that calls the
batch, over the traced batches' wall."""


def read(run):
    tr = run.trace
    if tr is None or not tr.window:
        return None
    spent = tr.span_s("upload_features")
    return 100.0 * spent / tr.window_s if spent else None
