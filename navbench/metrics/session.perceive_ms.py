"""Mean ms a session tick spends in the lidar layer: the scan transform,
the observation, their upload and mark/clear
(``NavigationSession._perceive``)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["perceive"])
