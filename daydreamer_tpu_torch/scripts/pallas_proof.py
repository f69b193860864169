"""Run the port's counterparts of the JAX package's Pallas kernels against
their plain PyTorch versions: the port of `scripts/pallas_proof.py`.

  `rssm`    - `ops.rssm.imagine` and `ops.rssm.observe` (the CUDA kernels
              `csrc/imagine.cu` and `csrc/observe.cu`). First a float32
              agreement check without sampling (deters' largest difference,
              share of equal one-hots) and, on a card, a sampling check
              (exact one-hots, steps differ). Then each kernel's time beside
              the plain loop's at the a1 and xarm shapes in bfloat16, on the
              same Gumbel noise, drawn once outside the timed region.
  `returns` - `ops.lambda_returns.gve` (a Triton kernel) against the plain
              backward loop, at three sizes.

The original times `lax.scan` at three `unroll` settings; a Python loop has
no such setting, so the plain loop is timed once. Times are taken with CUDA
events (the median of five windows) and only on a card: with `--device cpu`
every function runs once, the wrappers take their plain versions, and the
times are null. The script prints one JSON line per row and the whole
result last.

Usage: python -m daydreamer_tpu_torch.scripts.pallas_proof
       [--which rssm|returns|all] [--out FILE] [--device cuda|cpu]
"""

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from ..ops import lambda_returns as lr
from ..ops import rssm

# (name, cell, B, T, D, U, S, C, A, E): the production shapes.
CASES = (
    ('a1', 'observe', 32, 32, 256, 256, 32, 32, 12, 512),
    ('a1', 'imagine', 1024, 15, 256, 256, 32, 32, 12, 512),
    ('xarm', 'observe', 32, 32, 512, 512, 32, 32, 5, 512),
    ('xarm', 'imagine', 1024, 15, 512, 512, 32, 32, 5, 512),
)
# (B, T, D, U, S, C, A, E) of the float32 agreement check.
CORRECTNESS = (16, 6, 256, 256, 32, 32, 12, 512)
RETURNS = ((15, 64), (15, 256), (15, 2048))  # (horizon, lanes).
DTYPES = dict(float32=torch.float32, bfloat16=torch.bfloat16)


def timeit(fn, device, reps=10, warmup=3):
  """Microseconds per call of `fn` on a card: CUDA events around `reps`
  calls, the median of five such windows. None on the CPU."""
  if device.type != 'cuda':
    fn()
    return None
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(5):
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    begin.record()
    for _ in range(reps):
      fn()
    end.record()
    torch.cuda.synchronize(device)
    times.append(begin.elapsed_time(end) * 1e3 / reps)
  return float(np.median(times))


def make_inputs(seed, B, T, D, U, S, C, A, E, dtype, device):
  """Weights and one sequence from a numpy seed: one-hot stoch0, small
  normal deter0, unit normal actions and embeds, `is_first` on the first
  step, Gumbel noise."""
  rng = np.random.default_rng(seed)
  params = rssm.make_params(seed, D, U, S, C, A, E, prior_layers=3,
                            dtype=dtype, device=device)
  t = lambda x, dtype=dtype: torch.as_tensor(
      np.asarray(x, np.float32)).to(device, dtype)
  stoch0 = t(np.eye(C)[rng.integers(0, C, (B, S))].reshape(B, S * C))
  deter0 = t(0.1 * rng.standard_normal((B, D)))
  actions = t(rng.standard_normal((T, B, A)))
  embeds = t(rng.standard_normal((T, B, E)))
  is_first = torch.zeros((T, B), dtype=torch.bool, device=device)
  is_first[0] = True
  noise = t(rng.gumbel(size=(T, B, S * C)), torch.float32)
  return params, stoch0, deter0, actions, embeds, is_first, noise


def rssm_case(name, cell, B, T, D, U, S, C, A, E, dtype_name, device):
  """Time the kernel and the plain loop for one cell and shape."""
  params, stoch0, deter0, actions, embeds, is_first, noise = make_inputs(
      0, B, T, D, U, S, C, A, E, DTYPES[dtype_name], device)
  if cell == 'imagine':
    args = (params, stoch0, deter0, actions)
    kernel, plain = rssm.imagine, rssm.imagine_plain
  else:
    args = (params, stoch0, deter0, actions, embeds, is_first)
    kernel, plain = rssm.observe, rssm.observe_plain
  deters, logits, stochs = kernel(*args, noise=noise)
  sums = stochs.float().reshape(T, B, S, C).sum(-1)
  if not (bool(torch.isfinite(deters.float()).all())
          and bool(torch.isfinite(logits).all()) and bool((sums == 1).all())):
    raise AssertionError(f'{cell} at the {name} shape: an output is not '
                         'finite, or a stoch is no one-hot.')
  row = {'cell': cell, 'shape': name, 'dtype': dtype_name,
         'B': B, 'T': T, 'deter': D, 'units': U, 'stoch': [S, C]}
  row['plain_us'] = timeit(lambda: plain(*args, noise=noise), device, reps=3,
                           warmup=1)
  row['kernel_us'] = timeit(lambda: kernel(*args, noise=noise), device)
  row['speedup_vs_plain'] = (
      None if row['kernel_us'] is None
      else row['plain_us'] / row['kernel_us'])
  return row


def rssm_correctness(device, shape=CORRECTNESS):
  """float32 agreement of the wrappers with the plain versions without
  sampling and, on a card, validity of the sampled one-hots."""
  B, T, D, U, S, C, A, E = shape
  params, stoch0, deter0, actions, embeds, is_first, noise = make_inputs(
      1, B, T, D, U, S, C, A, E, torch.float32, device)
  d1, _, s1 = rssm.imagine_plain(params, stoch0, deter0, actions)
  d2, _, s2 = rssm.imagine(params, stoch0, deter0, actions, sample=False)
  args = (params, stoch0, deter0, actions, embeds, is_first)
  od1, _, os1 = rssm.observe_plain(*args)
  od2, _, os2 = rssm.observe(*args, sample=False)
  out = {
      'imagine_deter_maxdiff': float((d1 - d2).abs().max()),
      'imagine_stoch_agree': float((s1 == s2).float().mean()),
      'observe_deter_maxdiff': float((od1 - od2).abs().max()),
      'observe_stoch_agree': float((os1 == os2).float().mean()),
  }
  if device.type == 'cuda':
    # Sampling on the card, from the wrapper's own generator: every group
    # must be exactly one-hot and the steps must differ.
    generator = torch.Generator(device=device).manual_seed(11)
    _, _, s3 = rssm.imagine(
        params, stoch0, deter0, actions, generator=generator, sample=True)
    sums = s3.reshape(T, B, S, C).sum(-1)
    out['sample_onehot_ok'] = bool((sums == 1.0).all())
    out['sample_steps_differ'] = bool((s3[0] != s3[1]).any())
  return out


def returns_standalone(horizon, lanes, device):
  rng = np.random.default_rng(0)
  t = lambda x: torch.as_tensor(x.astype(np.float32)).to(device)
  interm = t(rng.normal(size=(horizon, lanes)))
  disc = t(rng.uniform(0.9, 1.0, size=(horizon, lanes)))
  boot = t(rng.normal(size=(lanes,)))
  lam = 0.95
  out_plain = lr.gve_plain(interm, disc, boot, lam)
  out_kernel = lr.gve(interm, disc, boot, lam)
  # The kernel may contract a product and a sum into one fused operation,
  # which moves a value by a unit in its last place.
  np.testing.assert_allclose(
      out_kernel.cpu().numpy(), out_plain.cpu().numpy(), rtol=1e-5, atol=1e-5)
  plain_us = timeit(
      lambda: lr.gve_plain(interm, disc, boot, lam), device, reps=200)
  kernel_us = timeit(lambda: lr.gve(interm, disc, boot, lam), device,
                     reps=200)
  return {'horizon': horizon, 'lanes': lanes, 'plain_us': plain_us,
          'kernel_us': kernel_us,
          'speedup': None if kernel_us is None else plain_us / kernel_us}


def main(argv=None, cases=CASES, correctness=CORRECTNESS, returns=RETURNS):
  """Runs the proof and returns its result. `cases`, `correctness` and
  `returns` are the shapes; the tests pass small ones."""
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--which', default='rssm',
                      choices=['rssm', 'returns', 'all'])
  parser.add_argument('--out', default='')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  args = parser.parse_args(argv)
  device = torch.device(args.device)
  if device.type == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError('No CUDA device is available; pass --device cpu to '
                         'run the plain versions on the CPU.')
    device = torch.device('cuda', torch.cuda.current_device())
    backend = torch.cuda.get_device_name(device)
  else:
    backend = 'cpu'
  result = {'backend': backend}

  if args.which in ('rssm', 'all'):
    print('correctness (f32, sample=False):', flush=True)
    result['rssm_correctness'] = rssm_correctness(device, correctness)
    print(json.dumps(result['rssm_correctness']), flush=True)
    rows = []
    for case in cases:
      row = rssm_case(*case, 'bfloat16', device)
      print('rssm', json.dumps(row), flush=True)
      rows.append(row)
    result['rssm_cells'] = rows

  if args.which in ('returns', 'all'):
    rows = []
    for horizon, lanes in returns:
      row = returns_standalone(horizon, lanes, device)
      print('returns', json.dumps(row), flush=True)
      rows.append(row)
    result['lambda_returns_standalone'] = rows

  print(json.dumps(result), flush=True)
  if args.out:
    pathlib.Path(args.out).write_text(json.dumps(result, indent=2))
  return result


if __name__ == '__main__':
  main()
  sys.exit(0)
