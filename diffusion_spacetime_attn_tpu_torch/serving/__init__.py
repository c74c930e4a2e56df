from .server import (  # noqa: F401
    BatchingService,
    ServiceSaturated,
    SpaceTimeEngine,
    TextToImageEngine,
    serve,
)
