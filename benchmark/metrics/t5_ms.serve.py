"""umT5 encode per request (the pipeline layer): the mean of
``WanT2V.timings["t5_s"]`` over the window's requests, in ms. The
pipeline times the encode of the prompt and the negative prompt on the
host clock, ending in a device synchronise."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["t5_s"]:
        return None
    return 1e3 * sum(ctx["t5_s"]) / len(ctx["t5_s"])
