from .build import build, load
