"""The trainer's wait for its next batch (the ``DataLoader`` layer): the
harness's host clock around taking each batch from the loader, mean per
optimizer step of the window, in ms."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["loader_wait_s"]:
        return None
    return 1e3 * sum(ctx["loader_wait_s"]) / len(ctx["loader_wait_s"])
