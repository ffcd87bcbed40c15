"""Run state and its listener bus (port of
bpbreid_tpu/utils/engine_state.py): the engine emits run, training,
epoch, batch and test events; listeners (the ``Writer``) react."""

__all__ = ['EngineState', 'EngineStateListener']


class EngineStateListener:
    def training_started(self):
        pass

    def training_completed(self):
        pass

    def epoch_started(self):
        pass

    def epoch_completed(self):
        pass

    def batch_started(self):
        pass

    def batch_completed(self):
        pass

    def test_started(self):
        pass

    def test_completed(self):
        pass

    def run_started(self):
        pass

    def run_completed(self):
        pass


class EngineState:
    # the last one built (JAX's ``current_engine_state``)
    _current = None

    def __init__(self, start_epoch=0, max_epoch=0):
        self.start_epoch = start_epoch
        self.max_epoch = max_epoch
        self.epoch = start_epoch
        self.batch = 0
        self.global_step = 0
        self.lr = 0.0
        self.listeners = []
        EngineState._current = self

    @classmethod
    def current_engine_state(cls):
        """The last ``EngineState`` built, or None."""
        return cls._current

    def add_listener(self, listener):
        self.listeners.append(listener)

    def _emit(self, event):
        for listener in self.listeners:
            getattr(listener, event)()

    def update_lr(self, lr):
        self.lr = float(lr)

    def run_started(self):
        self._emit('run_started')

    def run_completed(self):
        self._emit('run_completed')

    def training_started(self):
        self._emit('training_started')

    def training_completed(self):
        self._emit('training_completed')

    def epoch_started(self):
        self.batch = 0
        self._emit('epoch_started')

    def epoch_completed(self):
        self.epoch += 1
        self._emit('epoch_completed')

    def batch_started(self):
        self._emit('batch_started')

    def batch_completed(self):
        self.batch += 1
        self.global_step += 1
        self._emit('batch_completed')

    def test_started(self):
        self._emit('test_started')

    def test_completed(self):
        self._emit('test_completed')
