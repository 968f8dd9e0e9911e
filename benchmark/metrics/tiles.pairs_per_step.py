"""Pairs the binning made per window step (the step's own ``pairs``
metric), the compositor's work in records of one gaussian over one tile."""


def read(obs):
    return obs.get("pairs")
