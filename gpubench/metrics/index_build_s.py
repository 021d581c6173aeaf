"""IVF.fit plus IVF.build on the device, host clock ending in a sync."""


def read(run):
    if "fit" not in run.spans or "build" not in run.spans:
        return None
    return run.spans["fit"] + run.spans["build"]
