from . import rejection
