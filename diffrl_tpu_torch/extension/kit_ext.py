"""Omniverse Kit UI layer of the port (port of
diffrl_tpu/extension/kit_ext.py; needs an Omniverse runtime).

A dockable "diffrl" window with an experiment-script picker kept in the
USD stage's customLayerData, Run / Train / Stop / Reset actions driven one
tick per editor update, a policy-checkpoint picker, a live loss plot, a
streamed log, a record toggle, and the stage timeline synced to simulated
time (60 time codes per second).

Every ``omni.*`` / ``pxr`` import happens inside :meth:`on_startup` or the
methods the UI calls, so this module imports outside Kit; the headless
driver lives in :mod:`.experiment`. In Kit, register it through
``config/extension.toml``.
"""

from __future__ import annotations

from .experiment import Experiment, load_experiment_script

_SCRIPT_KEY = "diffrl_script"
_TPS = 60.0  # stage time codes per second


class DiffRLExtension:
    """omni.ext.IExt-compatible extension object."""

    def __init__(self):
        self.experiment: Experiment | None = None
        self.mode = "stopped"
        self._window = None
        self._plot = None
        self._log_label = None
        self._status = None
        self._update_sub = None
        self._stage_sub = None
        self._usd_context = None  # set by on_startup; None when headless
        self._timeline = None

    # ----------------------------------------------------------- lifecycle

    def on_startup(self, ext_id: str = ""):
        import omni.kit.app
        import omni.ui as ui
        import omni.usd

        self._ui = ui
        self._usd_context = omni.usd.get_context()
        try:
            import omni.timeline

            self._timeline = omni.timeline.get_timeline_interface()
        except Exception:
            self._timeline = None

        self._update_sub = (
            omni.kit.app.get_app().get_update_event_stream()
            .create_subscription_to_pop(self._on_update, name="diffrl"))
        self._stage_sub = (
            self._usd_context.get_stage_event_stream()
            .create_subscription_to_pop(self._on_stage, name="diffrl"))
        self.reload()
        self._build_ui()

    def on_shutdown(self):
        self._update_sub = None
        self._stage_sub = None
        self._window = None

    # ----------------------------------------------------- script handling

    def _stage_layer(self):
        if self._usd_context is None:
            return None
        stage = self._usd_context.get_stage()
        return None if stage is None else stage.GetEditTarget().GetLayer()

    def get_stage_script(self):
        layer = self._stage_layer()
        if layer is None:
            return None
        return layer.customLayerData.get(_SCRIPT_KEY)

    def set_stage_script(self, path: str):
        from pxr import Sdf

        layer = self._stage_layer()
        if layer is None:
            return
        with Sdf.ChangeBlock():
            data = dict(layer.customLayerData)
            data[_SCRIPT_KEY] = path
            layer.customLayerData = data
        self.reload()
        self._build_ui()

    def clear_stage_script(self):
        from pxr import Sdf

        layer = self._stage_layer()
        if layer is None:
            return
        with Sdf.ChangeBlock():
            data = dict(layer.customLayerData)
            data.pop(_SCRIPT_KEY, None)
            layer.customLayerData = data
        self.experiment = None
        self._build_ui()

    def reload(self):
        path = self.get_stage_script()
        if path:
            self.experiment = load_experiment_script(path)

    # ------------------------------------------------------------- actions

    def train(self):
        if self.experiment:
            self.experiment.reset()
            self.mode = "training"
            self._set_status("Training — press Stop to end")

    def run(self):
        if self.experiment:
            self.experiment.reset()
            self.mode = "inference"
            self._set_status("Inference — press Stop to end")

    def stop(self):
        self.mode = "stopped"
        self._set_status("Stopped")

    def reset(self):
        if self.experiment:
            self.experiment.reset()
        self.stop()

    # -------------------------------------------------------------- update

    def _on_update(self, _evt=None):
        exp = self.experiment
        if exp is None:
            return
        if self.mode == "training":
            exp.train()
            if self._plot is not None and exp.train_loss:
                lo = min(exp.train_loss)
                hi = max(exp.train_loss)
                self._plot.scale_min = lo
                self._plot.scale_max = hi if hi > lo else lo + 1.0
                self._plot.set_data(*exp.train_loss)
        elif self.mode == "inference":
            exp.run()

        stage = (None if self._usd_context is None
                 else self._usd_context.get_stage())
        if stage is not None:
            stage.SetStartTimeCode(0.0)
            stage.SetEndTimeCode(exp.render_time * _TPS)
            stage.SetTimeCodesPerSecond(_TPS)
        if self.mode != "stopped" and self._timeline is not None:
            self._timeline.set_current_time(exp.render_time)
        if self._log_label is not None:
            self._log_label.text = exp.log_output[-4000:]

    def _on_stage(self, evt):
        import omni.usd

        if evt.type == int(omni.usd.StageEventType.OPENED):
            self.reload()
            self._build_ui()

    # ------------------------------------------------------------------ ui

    def _set_status(self, text: str):
        if self._status is not None:
            self._status.text = text

    def _pick_file(self, title, on_done):
        try:
            from omni.kit.window.filepicker import FilePickerDialog

            def _apply(fname, dirname):
                dlg.hide()
                on_done(f"{dirname.rstrip('/')}/{fname}")

            dlg = FilePickerDialog(title, click_apply_handler=_apply)
            dlg.show()
        except Exception:
            self._set_status(f"{title}: file picker unavailable")

    def _build_ui(self):
        ui = self._ui
        self._window = ui.Window("diffrl", width=420, height=640)
        with self._window.frame:
            with ui.VStack(spacing=6):
                with ui.CollapsableFrame(title="Experiment", height=0):
                    with ui.VStack(spacing=4):
                        with ui.HStack():
                            ui.Label("Script", width=90)
                            ui.StringField().model.set_value(
                                self.get_stage_script() or "")
                            ui.Button("...", width=28, clicked_fn=lambda:
                                      self._pick_file("Select experiment "
                                                      "script",
                                                      self.set_stage_script))
                            ui.Button("Clear", width=48,
                                      clicked_fn=self.clear_stage_script)
                            ui.Button("Reload", width=56,
                                      clicked_fn=self.reload)
                if self.experiment is not None:
                    with ui.CollapsableFrame(title="Actions", height=0):
                        with ui.VStack(spacing=4):
                            with ui.HStack():
                                ui.Label("Network", width=90)
                                ui.StringField().model.set_value(
                                    self.experiment.network_file or "")
                                ui.Button("...", width=28, clicked_fn=lambda:
                                          self._pick_file(
                                              "Select policy checkpoint",
                                              self._set_network))
                            with ui.HStack(spacing=4):
                                ui.Button("Run", clicked_fn=self.run)
                                ui.Button("Train", clicked_fn=self.train)
                                ui.Button("Stop", clicked_fn=self.stop)
                                ui.Button("Reset", clicked_fn=self.reset)
                            with ui.HStack():
                                ui.Label("Record", width=90)
                                cb = ui.CheckBox(width=20)
                                cb.model.set_value(self.experiment.record)
                                cb.model.add_value_changed_fn(
                                    lambda m: setattr(self.experiment,
                                                      "record",
                                                      m.get_value_as_bool()))
                            with ui.HStack():
                                ui.Label("Status", width=90)
                                self._status = ui.Label("stopped")
                    with ui.CollapsableFrame(title="Loss", height=0):
                        self._plot = ui.Plot(
                            ui.Type.LINE, 0.0, 1.0, 0.0, height=180)
                    with ui.CollapsableFrame(title="Log", height=0):
                        self._log_label = ui.Label("", height=160,
                                                   word_wrap=True)

    def _set_network(self, path: str):
        if self.experiment is not None:
            self.experiment.network_file = path
        self._build_ui()


def get_extension():
    """Entry point mirroring the reference's module-level factory."""
    return DiffRLExtension()
