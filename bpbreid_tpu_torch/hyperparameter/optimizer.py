"""Hyper-parameter search in-process (port of
bpbreid_tpu/hyperparameter/optimizer.py).

The reference drives a ClearML HyperParameterOptimizer service with a
grid over loss variant / batch size, objective Test/rank1
(reference: torchreid/hyperparameter/hyperparameter_optimizer.py:39-100).
Here each trial builds a config from the base + overrides, trains and
tests through the port's ``build_model_engine`` and ``engine.run``, and
reports the objective; the results go to ``<save_dir>/hpo_results.json``
after each trial. Strategies: exhaustive grid or uniform random search
(``clearml_service.py`` runs the trials as ClearML tasks instead).
"""
import itertools
import json
import os
import os.path as osp
import random

__all__ = ['HyperParameterOptimizer', 'GridSearch', 'RandomSearch']


class GridSearch:
    def __init__(self, space):
        """space: dict of dotted-config-key -> list of values."""
        self.space = space

    def trials(self, max_trials=None):
        keys = list(self.space)
        combos = itertools.product(*(self.space[k] for k in keys))
        for i, values in enumerate(combos):
            if max_trials is not None and i >= max_trials:
                return
            yield dict(zip(keys, values))


class RandomSearch:
    def __init__(self, space, seed=0):
        """space: dict of key -> list (choice) or (lo, hi) tuple (uniform)."""
        self.space = space
        self.rng = random.Random(seed)

    def trials(self, max_trials=10):
        for _ in range(max_trials):
            trial = {}
            for k, v in self.space.items():
                if isinstance(v, tuple) and len(v) == 2 \
                        and all(isinstance(x, (int, float)) for x in v):
                    lo, hi = v
                    val = self.rng.uniform(lo, hi)
                    trial[k] = int(val) if isinstance(lo, int) \
                        and isinstance(hi, int) else val
                else:
                    trial[k] = self.rng.choice(list(v))
            yield trial


class HyperParameterOptimizer:
    """Runs trials of the standard training pipeline and tracks the best
    objective (default 'rank1', mirroring the reference's Test/rank1)."""

    def __init__(self, base_cfg, strategy, objective='rank1',
                 save_dir=None, train_fn=None):
        self.base_cfg = base_cfg
        self.strategy = strategy
        self.objective = objective
        self.save_dir = save_dir or base_cfg.data.save_dir
        self.train_fn = train_fn or self._default_train_fn
        self.results = []

    @staticmethod
    def _default_train_fn(cfg):
        from bpbreid_tpu_torch.config import engine_run_kwargs
        from bpbreid_tpu_torch.scripts.main import build_model_engine
        engine, _model = build_model_engine(cfg)
        cmc, mAP, ssmd, _ = engine.run(**engine_run_kwargs(cfg),
                                       max_epoch=cfg.train.max_epoch,
                                       eval_freq=cfg.train.eval_freq)
        return {'rank1': float(cmc[0]), 'mAP': float(mAP),
                'ssmd': float(ssmd)}

    def optimize(self, max_trials=None):
        best = None
        for i, overrides in enumerate(self.strategy.trials(max_trials)):
            cfg = self.base_cfg.clone()
            opts = []
            for k, v in overrides.items():
                opts += [k, str(v)]
            cfg.merge_from_list(opts)
            print('=== HPO trial {}: {} ==='.format(i, overrides))
            metrics = self.train_fn(cfg)
            record = {'trial': i, 'overrides': overrides,
                      'metrics': metrics}
            self.results.append(record)
            if best is None or metrics[self.objective] \
                    > best['metrics'][self.objective]:
                best = record
            if self.save_dir:
                os.makedirs(self.save_dir, exist_ok=True)
                with open(osp.join(self.save_dir, 'hpo_results.json'),
                          'w') as f:
                    json.dump({'results': self.results, 'best': best}, f,
                              indent=2)
        print('Best trial: {}'.format(best))
        return best
