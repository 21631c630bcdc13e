from . import (  # noqa: F401
    assignment,
    bezier,
    oned_kf,
    raycast,
    resampling,
    sonar,
    timeline,
)
