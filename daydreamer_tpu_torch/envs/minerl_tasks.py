"""MineRL task definitions: reward schedules, action vocabularies, and
import-gated herobraine env-spec registration.

Reference parity: embodied/envs/minerl_internal.py:1-282 (Wood/Table/Axe/
Diamond obtain specs with dense reward schedules, the open-ended Discover
spec, and per-task discrete action tables over the MineRL low-level action
dict). Everything below is plain data plus a `register(size)` entry point;
only `register` imports minerl, so this module stays importable (and the
action tables testable) without the MineRL runtime.
"""

# The MineRL low-level action dictionary and its no-op values. Discrete
# task actions are sparse overrides of this dict.
NOOP = dict(
    camera=(0, 0), forward=0, back=0, left=0, right=0, attack=0, sprint=0,
    jump=0, sneak=0, craft='none', nearbyCraft='none', nearbySmelt='none',
    place='none', equip='none')

# Locomotion/interaction primitives shared by every task.
_MOVE = {
    'noop': {},
    'attack': dict(attack=1),
    'turn_up': dict(camera=(-15, 0)),
    'turn_down': dict(camera=(15, 0)),
    'turn_left': dict(camera=(0, -15)),
    'turn_right': dict(camera=(0, 15)),
    'forward': dict(forward=1),
    'back': dict(back=1),
    'left': dict(left=1),
    'right': dict(right=1),
    'jump': dict(jump=1, forward=1),
    'place_dirt': dict(place='dirt'),
}


def _craft(*items):
  return {f'craft_{i}': dict(craft=i) for i in items}


def _near(*items):
  return {f'craft_{i}': dict(nearbyCraft=i) for i in items}


def _smelt(*items):
  return {f'smelt_{i}': dict(nearbySmelt=i) for i in items}


def _place(*items):
  return {f'place_{i}': dict(place=i) for i in items}


def _equip(*items):
  return {f'equip_{i}': dict(equip=i) for i in items}


_TABLE_CRAFTS = {
    **_craft('planks', 'stick', 'crafting_table'),
    **_place('crafting_table'),
}

_TOOL_TIERS = _near(
    'wooden_pickaxe', 'stone_pickaxe', 'iron_pickaxe') | _equip(
    'wooden_pickaxe', 'stone_pickaxe', 'iron_pickaxe')

ACTIONS = {
    'wood': dict(_MOVE),
    'table': {**_MOVE, **_TABLE_CRAFTS},
    'axe': {
        **_MOVE, **_TABLE_CRAFTS,
        **_near('wooden_axe'), **_equip('wooden_axe')},
    'diamond': {
        **_MOVE, **_TABLE_CRAFTS,
        **_craft('torch'),
        **_near('furnace'),
        **_smelt('coal', 'iron_ingot'),
        **_place('torch', 'cobblestone', 'furnace'),
        **_TOOL_TIERS},
    'discover': {
        **_MOVE, **_TABLE_CRAFTS,
        **_craft('torch', 'wheat'),
        **_near(
            'furnace', 'trapdoor', 'boat', 'bread', 'bucket', 'ladder',
            'fence', 'chest', 'bowl',
            'wooden_pickaxe', 'wooden_sword', 'wooden_shovel', 'wooden_axe',
            'stone_pickaxe', 'stone_sword', 'stone_shovel', 'stone_axe',
            'iron_pickaxe', 'iron_sword', 'iron_shovel', 'iron_axe'),
        **_smelt('coal', 'iron_ingot'),
        **_place('torch', 'cobblestone', 'furnace'),
        **_TOOL_TIERS},
}

# Milestone rewards for the obtain-style tasks: (item, reward). MineRL pays
# each milestone once (amount=1); `dense` also rewards intermediate items
# on every pickup.
REWARDS = {
    'wood': dict(dense=True, target='log', schedule=[('log', 10)]),
    'table': dict(dense=True, target='crafting_table', schedule=[
        ('log', 1), ('crafting_table', 10)]),
    'axe': dict(dense=True, target='wooden_axe', schedule=[
        ('log', 1), ('crafting_table', 1), ('wooden_axe', 10)]),
    'diamond': dict(dense=False, target='diamond', schedule=[
        ('log', 1), ('planks', 2), ('stick', 4), ('crafting_table', 4),
        ('wooden_pickaxe', 8), ('cobblestone', 16), ('furnace', 32),
        ('stone_pickaxe', 32), ('iron_ore', 64), ('iron_ingot', 128),
        ('iron_pickaxe', 256), ('diamond', 1024)]),
}


def env_id(task):
  return f'MinecraftTpu{task.title()}-v1'


def full_actions(task):
  """Per-task action table with NOOP defaults filled in."""
  table = {}
  for name, overrides in ACTIONS[task].items():
    action = dict(NOOP)
    action.update(overrides)
    table[name] = action
  return table


def register(task, size=(64, 64)):
  """Create and register the herobraine env spec for `task`; idempotent.

  Returns the gym env id. Requires the minerl package.
  """
  import gym as openai_gym
  try:
    registered = {s.id for s in openai_gym.envs.registry.all()}
  except AttributeError:  # newer gym: registry is a dict
    registered = set(openai_gym.envs.registry.keys())
  eid = env_id(task)
  if eid in registered:
    return eid
  if task == 'discover':
    spec = _discover_spec(size)
  else:
    spec = _obtain_spec(task, size)
  spec.register()
  return eid


def _obtain_spec(task, size):
  from minerl.herobraine.env_specs import obtain_specs
  info = REWARDS[task]

  class ObtainTask(obtain_specs.Obtain):

    def __init__(self):
      super().__init__(
          target_item=info['target'],
          dense=info['dense'],
          reward_schedule=[
              dict(type=item, amount=1, reward=reward)
              for item, reward in info['schedule']],
          # A very loose inner limit; the framework's TimeLimit wrapper
          # enforces the exact episode length outside MineRL.
          max_episode_steps=int(1e6),
          resolution=size,
      )
      self.name = env_id(task)

    def create_agent_handlers(self):
      # No terminate-on-target handler: keep the episode running so the
      # agent has time to collect the final item and receive its reward.
      return []

  return ObtainTask()


def _discover_spec(size):
  from minerl.herobraine.env_specs import simple_embodiment
  from minerl.herobraine.hero import handlers
  from minerl.herobraine.hero import mc

  class Discover(simple_embodiment.SimpleEmbodimentEnvSpec):
    """Open-ended world with the full item vocabulary exposed; reward is
    computed outside (new-item discovery bonus in the Minecraft env)."""

    def __init__(self):
      super().__init__(
          name=env_id('discover'), resolution=size,
          max_episode_steps=int(1e8))

    def create_rewardables(self):
      return []

    def create_agent_start(self):
      return []

    def create_agent_handlers(self):
      return []

    def create_server_world_generators(self):
      return [handlers.DefaultWorldGenerator(force_reset=True)]

    def create_server_quit_producers(self):
      return [handlers.ServerQuitWhenAnyAgentFinishes()]

    def create_server_decorators(self):
      return []

    def create_server_initial_conditions(self):
      return [
          handlers.TimeInitialCondition(
              allow_passage_of_time=True, start_time=0),
          handlers.SpawningInitialCondition(allow_spawning=True),
      ]

    def determine_success_from_rewards(self, rewards):
      return True

    def is_from_folder(self, folder):
      return folder == 'none'

    def get_docstring(self):
      return ''

    def create_mission_handlers(self):
      return []

    def create_observables(self):
      return [
          handlers.POVObservation(size),
          handlers.FlatInventoryObservation(mc.ALL_ITEMS),
          handlers.EquippedItemObservation(
              mc.ALL_ITEMS, _default='air', _other='other'),
      ]

    def create_actionables(self):
      kw = dict(_other='none', _default='none')
      return super().create_actionables() + [
          handlers.PlaceBlock(['none'] + mc.ALL_ITEMS, **kw),
          handlers.EquipAction(['none'] + mc.ALL_ITEMS, **kw),
          handlers.CraftAction(['none'] + mc.ALL_ITEMS, **kw),
          handlers.CraftNearbyAction(['none'] + mc.ALL_ITEMS, **kw),
          handlers.SmeltItemNearby(['none'] + mc.ALL_ITEMS, **kw),
      ]

  return Discover()
