"""The requests fed through ``SenseRecon.stream``: the program pulls the
next k-space from the client's iterator and yields each image in pinned
host memory, its copy enqueued behind its own solve."""


def entry(system):
    recon = getattr(system, "recon", None)
    if recon is None or not hasattr(recon, "stream"):
        raise ValueError("the stream entry needs a SenseRecon configuration")
    return "stream", recon.stream
