"""Test points predicted with their variance a second, over the whole window."""


def read(run):
    if not run.window_s or not run.units["points"]:
        return None
    return run.requests * run.units["points"] / run.window_s
