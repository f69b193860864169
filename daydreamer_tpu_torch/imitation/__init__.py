"""Motion-imitation learning harness: the port of
`daydreamer_tpu/imitation/`.

A clip-tracking reward on the quadruped sim plus a PPO trainer (reference:
motion_imitation/learning/{ppo_imitation,imitation_policies,
imitation_runners}.py, utilities/motion_data.py and
envs/env_wrappers/imitation_task.py). The clip and the task are copies of
the JAX package's NumPy modules; the trainer runs on the port's module
system in PyTorch. The sim (`ImitationA1`) needs MuJoCo, which
`envs/a1_model.py` imports at the first step, not here.
"""

from .motion_clip import MotionClip, synthesize_gait
from .task import ImitationA1
from .ppo import PPOImitation
