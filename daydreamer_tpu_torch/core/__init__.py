from .base import Agent, Env, Wrapper, Replay
from .batch import BatchEnv
from .checkpoint import Checkpoint
from .config import Config
from .convert import convert
from .counter import Counter
from .driver import Driver
from .flags import Flags
from .logger import (
    Logger, AsyncOutput, TerminalOutput, JSONLOutput, TensorBoardOutput,
    MLFlowOutput)
from .parallel import Parallel
from .path import Path
from .prefetch import Prefetch
from .random_agent import RandomAgent
from .space import Space
from .timer import Timer, global_timer
from .worker import Worker
from . import when
from . import wrappers
