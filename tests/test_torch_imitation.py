"""The port's motion imitation (`daydreamer_tpu_torch/imitation/`) against
the JAX package's, on the CPU.

The clip and the task are copies of the JAX package's NumPy modules, so the
same inputs give equal outputs (`assert_array_equal`, no tolerance), the
MuJoCo A1 included. PPO is a port: the JAX agent's state (its trainable
entries perturbed so that zero biases and a zero `log_std` matter) is
carried into the port by `load`, and both compute in float32. Tolerances:
outputs (mean action, value, log-prob, entropy), the loss and its gradients
rtol 1e-5 with atol 1e-6 for entries near zero; one update with one
minibatch (where the permutation cannot change the result) rtol 1e-5, atol
1e-6 for the state and the metrics, three updates rtol 1e-4, atol 1e-5.
GAE is a host loop on both sides and equal.
"""

import json

import jax
import numpy as np
import pytest
import torch

from daydreamer_tpu import nn as jnn
from daydreamer_tpu.imitation import motion_clip as jclip
from daydreamer_tpu.imitation import ppo as jppo
from daydreamer_tpu.imitation import task as jtask
from daydreamer_tpu.imitation import train as jtrain
from daydreamer_tpu_torch.imitation import motion_clip as pclip
from daydreamer_tpu_torch.imitation import ppo as pppo
from daydreamer_tpu_torch.imitation import task as ptask
from daydreamer_tpu_torch.imitation import train as ptrain

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
OBS, ACT, N = 30, 12, 32  # A1's imitation obs and actions; rollout rows.


def _clip_outputs(clip, times):
  return {
      'frames': clip.frames,
      'pose': np.stack([clip.pose_at(t) for t in times]),
      'joints': np.stack([clip.joints_at(t) for t in times]),
      'velocity': np.stack([clip.joint_velocity_at(t) for t in times]),
      'phase': np.array([clip.phase(t) for t in times]),
  }


def _assert_equal_trees(a, b):
  assert set(a) == set(b)
  for key in a:
    np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                  err_msg=key)


@pytest.mark.parametrize('gait', sorted(jclip.GAIT_PHASES))
def test_synthesized_clip_matches_jax(gait):
  times = np.random.default_rng(0).uniform(-0.2, 2.5, 20)
  for lib_a, lib_b in ((jclip, pclip), (jtask, ptask)):
    make_a = getattr(lib_a, 'synthesize_gait', None) or lib_a.a1_gait_clip
    make_b = getattr(lib_b, 'synthesize_gait', None) or lib_b.a1_gait_clip
    _assert_equal_trees(_clip_outputs(make_a(gait), times),
                        _clip_outputs(make_b(gait), times))


@pytest.mark.parametrize('loop', ['Wrap', 'Clamp'])
def test_clip_from_frames_matches_jax(loop):
  """Random frames, so that the slerp meets quaternions on both sides of
  each other (dot < 0) and far apart."""
  rng = np.random.default_rng(1)
  frames = rng.normal(size=(9, jclip.FRAME_DIM))
  quats = frames[:, jclip.QUAT]
  frames[:, jclip.QUAT] = quats / np.linalg.norm(quats, axis=1,
                                                 keepdims=True)
  times = rng.uniform(-0.1, 1.2, 20)
  clips = [lib.MotionClip(frames, 0.05, loop=loop) for lib in (jclip, pclip)]
  _assert_equal_trees(*(_clip_outputs(c, times) for c in clips))


def test_clip_file_crosses_packages(tmp_path):
  for (save_lib, load_lib) in ((pclip, jclip), (jclip, pclip)):
    path = tmp_path / f'{save_lib.__name__}.txt'
    clip = save_lib.synthesize_gait('bound', n_frames=12)
    clip.save(str(path))
    loaded = load_lib.MotionClip.from_file(str(path))
    np.testing.assert_array_equal(loaded.frames, clip.frames)
    assert (loaded.frame_duration, loaded.loop, loaded.cycle_offset_position
            ) == (clip.frame_duration, clip.loop, clip.cycle_offset_position)
  assert json.loads(path.read_text())['LoopMode'] == 'Wrap'


def test_imitation_a1_matches_jax():
  """The same 10 actions through both sims: 5 steps, then the trunk is
  turned upside down in both, the next step ends the episode as a fall
  (`is_last` and `is_terminal`), and a reset and 2 more steps follow."""
  envs = [lib.ImitationA1(seed=3, length=20, repeat=2)
          for lib in (ptask, jtask)]
  try:
    spaces = [{k: (v.shape, v.dtype) for k, v in env.obs_space.items()}
              for env in envs]
    assert spaces[0] == spaces[1]
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (10, ACT)).astype(np.float32)
    resets = [True] + [False] * 6 + [True] + [False] * 2
    outs = [[], []]
    for i, (action, reset) in enumerate(zip(actions, resets)):
      for env, out in zip(envs, outs):
        if i == 6:
          env._robot.data.qpos[3:7] = (0.0, 1.0, 0.0, 0.0)  # wxyz: flipped.
        out.append(env.step({'action': action, 'reset': reset}))
    for port, ref in zip(*outs):
      _assert_equal_trees(port, ref)
    port = outs[0]
    assert port[0]['vector'].shape == (OBS,)
    assert [bool(o['is_last']) for o in port] == [False] * 6 + [True] + [
        False] * 3
    assert port[6]['is_terminal'] and not port[5]['is_terminal']
    assert port[7]['is_first'] and np.isfinite(port[9]['reward'])
  finally:
    for env in envs:
      env.close()


def _agents(**kw):
  """A JAX agent with perturbed trainable entries and the port's agent (on
  the CPU) carrying its state."""
  jagent = jppo.PPOImitation(OBS, ACT, seed=1, **kw)
  rng = np.random.default_rng(2)
  state = jagent.save()
  for key, value in state.items():
    if key.startswith('ppo/'):
      state[key] = (value + 0.1 * rng.standard_normal(value.shape)).astype(
          value.dtype)
  jagent.load(state)
  pagent = pppo.PPOImitation(OBS, ACT, seed=1, device='cpu', **kw)
  pagent.load(jagent.save())
  return jagent, pagent


def _rollout(seed=3, n=N):
  rng = np.random.default_rng(seed)
  return dict(
      obs=rng.standard_normal((n, OBS)).astype(np.float32),
      action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
      logp=rng.normal(-12, 1, n).astype(np.float32),
      adv=rng.standard_normal(n).astype(np.float32),
      ret=rng.standard_normal(n).astype(np.float32))


def _port_batch(batch):
  return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_ppo_outputs_match_jax():
  jagent, pagent = _agents()
  batch = _rollout()

  def outputs(obs, action):
    d = jagent.net.dist(obs)
    return (d.mode(), jagent.net.value_fn(obs), d.log_prob(action),
            d.entropy())

  want, _ = jnn.pure(outputs)(jagent.state, 0, batch['obs'],
                              batch['action'])
  with torch.no_grad():
    obs = torch.as_tensor(batch['obs'])
    d = pagent.net.dist(obs)
    got = (d.mode(), pagent.net.value_fn(obs),
           d.log_prob(torch.as_tensor(batch['action'])), d.entropy())
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
  np.testing.assert_allclose(pagent.mean_act(batch['obs']),
                             jagent.mean_act(batch['obs']), **TOL)
  np.testing.assert_allclose(pagent.act(batch['obs'])[2],
                             jagent.act(batch['obs'])[2], **TOL)


def test_ppo_loss_and_grads_match_jax():
  jagent, pagent = _agents()
  batch = _rollout()
  keys = sorted(k for k in jagent.state if k.startswith('ppo/'))
  (loss, _, grads, (aux,)), _ = jnn.pure(
      lambda b: jnn.value_and_grad(jagent._loss, keys, b))(
          jagent.state, 0, batch)
  params = dict(pagent.net.named_state(trainable=True))
  assert sorted(params) == keys
  ploss, paux = pagent._loss(_port_batch(batch))
  pgrads = torch.autograd.grad(ploss, [params[k] for k in keys])
  np.testing.assert_allclose(ploss.item(), float(loss), **TOL)
  for name in aux:
    np.testing.assert_allclose(paux[name].item(), float(aux[name]), **TOL)
  for key, grad in zip(keys, pgrads):
    np.testing.assert_allclose(grad.numpy(), np.asarray(grads[key]),
                               err_msg=key, **TOL)


@pytest.mark.parametrize('epochs,tol', [
    (1, TOL), (3, dict(rtol=1e-4, atol=1e-5))])
def test_ppo_update_matches_jax(epochs, tol):
  jagent, pagent = _agents(epochs=epochs, minibatches=1)
  batch = _rollout()
  jmets = jagent.update(batch)
  pmets = pagent.update(batch)
  assert set(pmets) == set(jmets)
  for key in jmets:
    np.testing.assert_allclose(pmets[key], jmets[key], err_msg=key, **tol)
  assert pmets['ppo_opt_grad_steps'] == epochs
  jstate, pstate = jagent.save(), pagent.save()
  assert set(pstate) == set(jstate)
  for key in jstate:
    assert pstate[key].dtype == jstate[key].dtype, key
    np.testing.assert_allclose(pstate[key], jstate[key], err_msg=key, **tol)


def test_gae_matches_jax():
  jagent, pagent = _agents()
  rng = np.random.default_rng(4)
  rewards = rng.standard_normal(64).astype(np.float32)
  values = rng.standard_normal(64).astype(np.float32)
  conts = (rng.uniform(size=64) > 0.1).astype(np.float32)
  last = np.float32(rng.standard_normal())
  for got, want in zip(pagent.gae(rewards, values, conts, last),
                       jagent.gae(rewards, values, conts, last)):
    np.testing.assert_array_equal(got, want)


def test_save_loads_into_jax():
  """The port's own state, saved, loads into the JAX agent, which then
  gives the port's values."""
  pagent = pppo.PPOImitation(OBS, ACT, seed=5, device='cpu')
  pagent.update(_rollout())
  jagent = jppo.PPOImitation(OBS, ACT, seed=1)
  saved = pagent.save()
  assert {k: (v.shape, v.dtype) for k, v in saved.items()} == {
      k: (v.shape, v.dtype) for k, v in jagent.save().items()}
  jagent.load(saved)
  obs = _rollout()['obs']
  np.testing.assert_allclose(pagent.act(obs)[2], jagent.act(obs)[2], **TOL)
  np.testing.assert_allclose(pagent.mean_act(obs), jagent.mean_act(obs),
                             **TOL)
  assert int(saved['ppo_opt/step']) == 40


def test_default_shape_learns():
  """The default schedule (10 epochs of 4 minibatches) by behavior, as
  tests/test_imitation.py holds the JAX agent: the losses stay finite and
  an advantage that favours action 0 > 0 raises the mean of action 0."""
  agent = pppo.PPOImitation(6, 3, seed=1, device='cpu')
  rng = np.random.default_rng(0)
  obs = rng.normal(size=(64, 6)).astype(np.float32)
  action, logp, value = agent.act(obs)
  assert action.shape == (64, 3) and logp.shape == value.shape == (64,)
  assert np.isfinite(logp).all() and np.isfinite(value).all()
  adv = np.sign(action[:, 0]).astype(np.float32)
  rollout = dict(obs=obs, action=action, logp=logp, adv=adv,
                 ret=value + adv)
  before = agent.mean_act(obs)[:, 0].mean()
  for _ in range(5):
    metrics = agent.update(rollout)
  assert all(np.isfinite(v) for v in metrics.values()), metrics
  assert metrics['ppo_opt_grad_steps'] == 200
  assert agent.mean_act(obs)[:, 0].mean() > before


def test_trainers_end_to_end(tmp_path):
  args = ['--steps', '256', '--horizon', '64', '--length', '20',
          '--repeat', '2']
  keys = []
  for name, main, extra in (('jax', jtrain.main, []),
                            ('port', ptrain.main, ['--platform', 'cpu'])):
    logdir = tmp_path / name
    returns = main([*args, *extra, '--logdir', str(logdir)])
    assert len(returns) >= 12 and all(np.isfinite(returns))
    rows = [json.loads(line) for line in
            (logdir / 'metrics.jsonl').read_text().splitlines()]
    keys.append(sorted({k for row in rows for k in row}))
  assert keys[0] == keys[1]
  assert 'ppo_opt_loss' in keys[1] and 'episode/score' in keys[1]
  assert jax.default_backend() == 'cpu'


def test_no_silent_cpu(monkeypatch, tmp_path):
  """Without a card, the trainer and the agent raise unless the CPU is
  asked for."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='--platform cpu'):
    ptrain.main(['--steps', '4', '--logdir', str(tmp_path)])
  with pytest.raises(RuntimeError, match='no CUDA device'):
    pppo.PPOImitation(OBS, ACT)
  assert not list(tmp_path.iterdir())
