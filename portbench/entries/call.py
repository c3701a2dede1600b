"""One call per request: the configuration's own request path,
``System.serve(y)``, k-space in and the image in host memory out."""


def entry(system):
    return "call", system.serve
