"""Input pipeline: host milliseconds a step of getting the next batch
(``GraspDataset.batches``: scene files read, resampled, augmented) and
uploading it (``trainer.device_batch``): the harness's ``input`` span."""


def read(ctx):
    if ctx["mode"] != "train" or not ctx["per_unit"]:
        return None
    return ctx["spans"].total_ms("input") / ctx["per_unit"]
