"""Logger: the experiment-tracker mux (port of the ``Logger`` of
bpbreid_tpu/utils/logging.py).

Scalars are kept in memory (``scalars``) and sent to the optional
backends: TensorBoard and wandb are each used when the config asks for
it and its package imports, and skipped with a message otherwise.
Figures are ``[H, W, 3]`` uint8 canvases (the port draws without
matplotlib), written as PNGs under ``<save_dir>/figures/`` when
``project.logger.save_disk`` is set; their titles go into ``tEXt``
chunks. Unlike JAX's ``add_figure``, a failed write raises.
"""
import os
import os.path as osp

from bpbreid_tpu_torch.data.datasets.dataset import write_png

__all__ = ['Logger']


class Logger:
    def __init__(self, config=None, save_dir=None):
        self.cfg = config
        self.save_dir = save_dir or (config.data.save_dir if config else 'logs')
        self.scalars = []
        self._backends = []
        if config is not None:
            lg = config.project.logger
            if lg.use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._backends.append(
                        ('tb', SummaryWriter(log_dir=self.save_dir)))
                except ImportError:
                    print('tensorboard unavailable; falling back to disk logs')
            if lg.use_wandb:
                try:
                    import wandb
                    wandb.init(project=config.project.name,
                               name=config.project.experiment_name or None,
                               config=config.to_dict())
                    self._backends.append(('wandb', wandb))
                except ImportError:
                    print('wandb unavailable; falling back to disk logs')

    def add_scalar(self, name, value, step=None):
        self.scalars.append({'name': name, 'value': float(value),
                             'step': step})
        for kind, b in self._backends:
            if kind == 'tb':
                b.add_scalar(name, value, step)
            elif kind == 'wandb':
                b.log({name: value}, step=step)

    def add_figure(self, name, canvas, step=None, text=None):
        """Write ``canvas`` to ``<save_dir>/figures/<name>_<step>.png``
        (``/`` in ``name`` as ``_``, step 0 when None) with ``text`` as
        ``tEXt`` chunks; returns the path, or None when the config does
        not ask for figures on disk (or there is no config)."""
        if self.cfg is None or not self.cfg.project.logger.save_disk:
            return None
        d = osp.join(self.save_dir, 'figures')
        os.makedirs(d, exist_ok=True)
        path = osp.join(d, '{}_{}.png'.format(name.replace('/', '_'),
                                              step or 0))
        write_png(path, canvas, text)
        return path

    def add_image(self, name, image, step=None):
        """An ``[H, W, 3]`` uint8 image, written as ``add_figure`` writes
        a canvas."""
        return self.add_figure(name, image, step)
