"""End-to-end learner throughput, `imag_impl: pallas` against `scan`, on
the card: the port of `scripts/imag_impl_bench.py`.

What the fused rollout with the actor inside (imagine_actor) buys the whole
update on the learner's path (`bench.measure_updates`) at the xarm training
shape (K = 16, `rssm.impl: pallas` in both arms): the discrete-action robot
config, where the fused rollout engages. The a1 config is continuous: its
rollout runs inside the actor's loss, so the forward-only kernel does not
apply there. Each arm reports its updates/s, first dispatch and MFU (both
divided by the same loop-path count of the update's work), and `speedup`
is pallas over scan. In the pallas arm imagine_actor must launch once a
timed update. It only measures: the configs keep `imag_impl: scan`.

Usage:
  python -m daydreamer_tpu_torch.scripts.imag_impl_bench [--out FILE] \\
      [--budget 90] [--device cuda|cpu]
"""

import argparse
import json
import pathlib

from . import bench

KERNELS = ('imagine_actor',)


def run_shape(name, task, overrides, K, budget, device='cuda'):
  return bench.compare_impls(
      name, 'imag_impl', task, {**overrides, 'rssm.impl': 'pallas'}, K,
      budget, device, KERNELS)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--out', default='')
  parser.add_argument('--budget', type=float, default=90.0)
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  args = parser.parse_args(argv)
  device = bench.resolve_device(args.device)
  task, overrides, _ = bench.SHAPES['xarm']
  result = {'kernel_build': bench.kernel_build(device),
            'device': bench.describe(device),
            'xarm': run_shape('xarm', task, overrides, 16, args.budget,
                              device)}
  if device.type == 'cuda':
    print(bench.card(), flush=True)
  if args.out:
    pathlib.Path(args.out).write_text(json.dumps(result, indent=2) + '\n')
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
