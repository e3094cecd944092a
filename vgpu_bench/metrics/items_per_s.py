"""Items (images or sequences) that all tenants completed over the window
from the first tenant's start to the last one's end."""


def read(run):
    return run.items / run.window_s
