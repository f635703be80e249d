"""Keras-frontend callbacks (a port of
``flexflow_tpu.frontends.keras_callbacks``; reference:
python/flexflow/keras/callbacks.py).

Same surface: ``Callback`` base with the six hooks, ``LearningRateScheduler``
(epoch-indexed schedule driving optimizer.set_learning_rate),
``VerifyMetrics`` (asserts final accuracy) and ``EpochVerifyMetrics``
(per-epoch accuracy check with early stop). Callbacks are invoked by the
keras models' ``fit`` (models drive FFModel.fit one epoch at a time so the
epoch hooks fire exactly like the reference's base_model.py loop).
"""
from __future__ import annotations

import numpy as np


class Callback:
    """reference: callbacks.py Callback."""

    def __init__(self):
        self.validation_data = None
        self.model = None
        self.params = None

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, batch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass


class LearningRateScheduler(Callback):
    """reference: callbacks.py LearningRateScheduler — calls
    ``optimizer.set_learning_rate(schedule(epoch))`` each epoch begin."""

    def __init__(self, schedule):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        optimizer = self.model.ffmodel.optimizer
        if not hasattr(optimizer, "lr") and not hasattr(optimizer, "alpha"):
            raise ValueError('Optimizer must have a "lr" attribute.')
        lr = self.schedule(epoch)
        if not isinstance(lr, (float, np.float32, np.float64)):
            raise ValueError('The output of the "schedule" function '
                             'should be float.')
        optimizer.set_learning_rate(lr)
        print("set learning rate ", lr)


class VerifyMetrics(Callback):
    """reference: callbacks.py VerifyMetrics — asserts accuracy at train
    end. Accepts a float or an enum-like object with ``.value``."""

    def __init__(self, accuracy):
        super().__init__()
        self.accuracy = getattr(accuracy, "value", accuracy)

    def on_train_end(self, logs=None):
        perf = self.model.ffmodel.get_perf_metrics()
        accuracy = perf.get_accuracy()
        if accuracy < self.accuracy:
            assert 0, "Accuracy is wrong"


class TelemetryCallback(Callback):
    """Streams epoch/train progress into the obs tracer and (optionally)
    writes a merged telemetry summary at train end — the Keras-surface entry
    point to the tracing/telemetry subsystem (no reference analog; the
    reference's callbacks only print).

    The keras fit loop drives ``ffmodel.fit(epochs=1)`` once per epoch, so
    each epoch yields its own StepTelemetry; this callback collects every
    epoch's summary and writes one ``{"epochs": [...]}`` record (only the
    first epoch's first step carries the capture)."""

    def __init__(self, telemetry_file=None):
        super().__init__()
        self.telemetry_file = telemetry_file
        self.epoch_summaries = []

    def _tracer(self):
        from ..obs import get_tracer

        return get_tracer()

    def on_train_begin(self, logs=None):
        # the callback's telemetry_file IS an observability opt-in: flag the
        # model so fit() records a StepTelemetry even with no config sinks
        if self.telemetry_file and self.model is not None:
            self.model.ffmodel._telemetry_requested = True
        self.epoch_summaries = []
        self._tracer().event("keras_train_begin")

    def on_epoch_end(self, epoch, logs=None):
        tel = self.model.ffmodel.get_telemetry()
        if tel is not None:
            tel.finalize()
            self.epoch_summaries.append(dict(tel.summary(), epoch=epoch))
        if self.telemetry_file:
            # the keras fit loop drives one ffmodel.fit per epoch and each
            # fit CONSUMES the request flag — re-arm for the next epoch
            self.model.ffmodel._telemetry_requested = True
        tracer = self._tracer()
        if not tracer.enabled:
            return
        perf = self.model.ffmodel.get_perf_metrics()
        tracer.event("keras_epoch_end", epoch=epoch,
                     accuracy=round(perf.accuracy(), 4),
                     train_all=perf.train_all)

    def on_train_end(self, logs=None):
        self._tracer().event("keras_train_end")
        if self.model is not None:
            # scoped opt-in: a later fit() without this callback must not
            # stay instrumented (telemetry costs a per-step device sync)
            self.model.ffmodel._telemetry_requested = False
        if self.telemetry_file and self.epoch_summaries:
            from ..obs import atomic_write_json

            atomic_write_json(self.telemetry_file,
                              {"phase": "train",
                               "epochs": self.epoch_summaries})


class EpochVerifyMetrics(Callback):
    """reference: callbacks.py EpochVerifyMetrics — early-stops once the
    per-epoch accuracy passes the bar."""

    def __init__(self, accuracy, early_stop=True):
        super().__init__()
        self.accuracy = getattr(accuracy, "value", accuracy)
        self.early_stop = early_stop

    def on_epoch_end(self, epoch=None, logs=None):
        perf = self.model.ffmodel.get_perf_metrics()
        accuracy = perf.get_accuracy()
        if not self.early_stop:
            return False
        return accuracy > self.accuracy
