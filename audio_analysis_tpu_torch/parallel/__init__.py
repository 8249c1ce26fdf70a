"""Figure rendering beside the device work (audio_analysis_tpu/parallel):
parallel.overlap, the plot-worker thread of the report suite, and
parallel.procpool, a spawn-based process pool with the same contract."""

from audio_analysis_tpu_torch.parallel.overlap import (  # noqa: F401
    BorrowedPlotWorker,
    MaybePlotWorker,
    PlotWorker,
    make_plot_worker,
)
