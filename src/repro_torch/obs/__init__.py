"""``repro_torch.obs`` — the simulator's own PMU, the twin of ``repro.obs``.

* :mod:`repro_torch.obs.telemetry` — per-quantum device telemetry rings,
  stacked on the device and fetched once after a run;
* :mod:`repro_torch.obs.trace` — host span tracing as Chrome/Perfetto
  trace events, each span a ``torch.profiler.record_function`` too;
* :mod:`repro_torch.obs.metrics` — the version-stamped run export;
* :mod:`repro_torch.obs.accuracy` — per-application prediction accuracy
  over the app rings.
"""

from repro_torch.obs.accuracy import (  # noqa: F401
    accuracy_report,
    drift_windows,
    error_ccdf,
    error_stack,
    report_metrics,
)
from repro_torch.obs.metrics import (  # noqa: F401
    OBS_SCHEMA_VERSION,
    READABLE_SCHEMAS,
    export_run,
    load_run,
    save_run,
    version_stamp,
)
from repro_torch.obs.telemetry import (  # noqa: F401
    APP_FIELDS,
    CLOSED_FIELDS,
    FAULT_FIELDS,
    FUSED_DIAG_FIELDS,
    OPEN_FIELDS,
    AppTelemetryLog,
    TelemetryLog,
)
from repro_torch.obs.trace import span  # noqa: F401
