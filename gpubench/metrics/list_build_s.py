"""The benchmark's span around IVF.build (list assignment, encoding, the
CSR tiles and, for the exact engine, its vector tiles), ending in a
sync."""


def read(run):
    return run.spans.get("build")
