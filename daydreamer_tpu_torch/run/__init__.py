from .train import train
from .train_eval import train_eval
from .train_fixed_eval import train_fixed_eval
from .learning import learning
from .acting import acting
