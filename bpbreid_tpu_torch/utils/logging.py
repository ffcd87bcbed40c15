"""Logger: the experiment-tracker mux (port of the ``Logger`` of
bpbreid_tpu/utils/logging.py).

Scalars are kept in memory (``scalars``) and sent to the optional
backends: TensorBoard and wandb are each used when the config asks for
it and its package imports, and skipped with a message otherwise.
"""

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
