"""Round-robin over multiple replays, one buffer per batch lane
(reference: embodied/replay/dispatch.py:4-29)."""


class Dispatch:

  def __init__(self, replays):
    self.replays = replays
    self.index = 0

  def __len__(self):
    return sum(len(replay) for replay in self.replays)

  @property
  def stats(self):
    stats = {}
    for replay in self.replays:
      stats.update(replay.stats)
    return stats

  def add(self, tran, worker=0):
    self.replays[worker % len(self.replays)].add(tran, worker)

  def add_traj(self, traj):
    self.replays[self.index % len(self.replays)].add_traj(traj)
    self.index += 1

  def dataset(self):
    iterators = [replay.dataset() for replay in self.replays]
    while True:
      for iterator in iterators:
        yield next(iterator)

  def prioritize(self, keys, priorities):
    for replay in self.replays:
      replay.prioritize(keys, priorities)

  def save(self):
    return [replay.save() for replay in self.replays]

  def load(self, data):
    for replay, chunk in zip(self.replays, data):
      replay.load(chunk)
