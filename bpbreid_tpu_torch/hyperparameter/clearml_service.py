"""ClearML service integration for hyper-parameter optimization (port of
bpbreid_tpu/hyperparameter/clearml_service.py).

The reference drives a ClearML ``HyperParameterOptimizer`` service: it
registers itself as an optimizer task, clones a template training task
per trial, enqueues the clones on a remote execution queue and polls
their reported objective
(reference: torchreid/hyperparameter/hyperparameter_optimizer.py:20-100).

This module provides the same service surface on top of the port's
config tree. It is import-gated: ``clearml`` is not part of the core
dependency set, so the client is constructed lazily and raises a clear
error when the SDK is absent. The in-process search
(:mod:`bpbreid_tpu_torch.hyperparameter.optimizer`) remains the default:
it needs no service and runs the trials in this process; this client is
for fleets with a ClearML scheduler where each trial should run as its
own (possibly remote) task.

Mapping to the reference's knobs:

===============================  =======================================
reference (clearml script)        here
===============================  =======================================
``DiscreteParameterRange(         ``hyper_parameters={'loss.part_based.
'General/loss/part_based/name',   name': [...]}`` — dotted config keys,
[...])``                          auto-prefixed with ``General/``
``objective_metric_title/series`` ``objective='rank1'`` (Test/<name>)
``execution_queue='default'``     ``execution_queue``
``total_max_jobs``                ``total_max_jobs``
``run_as_service``                ``launch(run_as_service=True)``
===============================  =======================================
"""
import importlib

__all__ = ['ClearMLServiceOptimizer', 'clone_task_with_overrides',
           'clearml_available']


def _clearml():
    """Import the clearml SDK lazily with a clear failure mode."""
    try:
        clearml = importlib.import_module('clearml')
        automation = importlib.import_module('clearml.automation')
    except ImportError as e:
        raise ImportError(
            'ClearML service HPO needs the clearml SDK, which is not part '
            'of the core dependencies. Install clearml, or use the '
            'in-process search '
            '(bpbreid_tpu_torch.hyperparameter.HyperParameterOptimizer), '
            'which runs trials locally without any service.') from e
    return clearml, automation


def clearml_available():
    try:
        importlib.import_module('clearml')
        return True
    except ImportError:
        return False


def _to_general(key):
    """Dotted config key -> ClearML 'General/...' parameter path (the
    reference stores the config under the task's General section, e.g.
    'General/loss/part_based/name')."""
    if key.startswith('General/'):
        return key
    return 'General/' + key.replace('.', '/')


def clone_task_with_overrides(template_task_id, overrides,
                              execution_queue='default', name=None):
    """Clone a training task, override config parameters, and enqueue
    the clone on a remote execution queue — the primitive behind every
    service trial (what ``clearml.automation`` does internally per job).

    Args:
        template_task_id: id of the training task to clone.
        overrides: dict of dotted config key -> value.
        execution_queue: ClearML queue name to enqueue the clone on.
        name: optional name for the cloned task.
    Returns:
        The cloned (enqueued) Task object.
    """
    clearml, _ = _clearml()
    Task = clearml.Task
    cloned = Task.clone(source_task=template_task_id, name=name)
    cloned.set_parameters(
        {_to_general(k): v for k, v in overrides.items()})
    Task.enqueue(cloned, queue_name=execution_queue)
    return cloned


class ClearMLServiceOptimizer:
    """Service-backed HPO client mirroring the reference script.

    Args:
        template_task_id: the training task to clone per trial.
        hyper_parameters: dict of dotted config key -> list of values
            (discrete range) or (lo, hi) int tuple (uniform integer
            range).
        objective: metric name; reported by the training task as
            ``Test/<objective>`` (the reference uses Test/rank1).
        objective_sign: 'max' or 'min'.
        strategy: 'grid' | 'random' (clearml optimizer class to use).
        execution_queue: queue the trial tasks are enqueued on.
        max_concurrent: concurrent trial tasks.
        total_max_jobs: total trial budget.
        pool_period_min: service poll period, minutes.
        project_name / task_name: the optimizer task's identity.
    """

    def __init__(self, template_task_id, hyper_parameters,
                 objective='rank1', objective_sign='max', strategy='grid',
                 execution_queue='default', max_concurrent=1,
                 total_max_jobs=10, pool_period_min=5.0,
                 time_limit_per_job=None,
                 project_name='Hyper-Parameter Optimization',
                 task_name='Automatic Hyper-Parameter Optimization'):
        self.template_task_id = template_task_id
        self.hyper_parameters = dict(hyper_parameters)
        self.objective = objective
        self.objective_sign = objective_sign
        self.strategy = strategy
        self.execution_queue = execution_queue
        self.max_concurrent = max_concurrent
        self.total_max_jobs = total_max_jobs
        self.pool_period_min = pool_period_min
        self.time_limit_per_job = time_limit_per_job
        self.project_name = project_name
        self.task_name = task_name
        self.task = None
        self.optimizer = None

    def _parameter_ranges(self, automation):
        ranges = []
        for key, spec in self.hyper_parameters.items():
            name = _to_general(key)
            if isinstance(spec, tuple) and len(spec) == 2 \
                    and all(isinstance(x, int) for x in spec):
                ranges.append(automation.UniformIntegerParameterRange(
                    name, min_value=spec[0], max_value=spec[1]))
            else:
                ranges.append(automation.DiscreteParameterRange(
                    name, values=list(spec)))
        return ranges

    def launch(self, run_as_service=False, job_complete_callback=None):
        """Register the optimizer task and run the search.

        ``run_as_service=True`` enqueues THIS task on the 'services'
        queue and returns immediately (the reference's
        ``task.execute_remotely(queue_name='services', exit_process=True)``
        path); otherwise the search runs here, blocking until the trial
        budget is exhausted, and returns the top experiment ids.
        """
        clearml, automation = _clearml()
        Task = clearml.Task
        self.task = Task.init(
            project_name=self.project_name, task_name=self.task_name,
            task_type=Task.TaskTypes.optimizer, reuse_last_task_id=False)
        args = {'template_task_id': self.template_task_id,
                'run_as_service': run_as_service}
        args = self.task.connect(args)
        optimizer_class = (automation.GridSearch
                           if self.strategy == 'grid'
                           else automation.RandomSearch)
        self.optimizer = automation.HyperParameterOptimizer(
            base_task_id=args['template_task_id'],
            hyper_parameters=self._parameter_ranges(automation),
            objective_metric_title='Test/{}'.format(self.objective),
            objective_metric_series='Test/{}'.format(self.objective),
            objective_metric_sign=self.objective_sign,
            max_number_of_concurrent_tasks=self.max_concurrent,
            optimizer_class=optimizer_class,
            execution_queue=self.execution_queue,
            time_limit_per_job=self.time_limit_per_job,
            pool_period_min=self.pool_period_min,
            total_max_jobs=self.total_max_jobs)
        if args['run_as_service']:
            self.task.execute_remotely(queue_name='services',
                                       exit_process=True)
            return None
        self.optimizer.set_report_period(self.pool_period_min)
        self.optimizer.start(
            job_complete_callback=job_complete_callback)
        self.optimizer.wait()
        top = self.optimizer.get_top_experiments(top_k=3)
        self.optimizer.stop()
        return top
