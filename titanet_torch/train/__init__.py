"""Engine of the port: :mod:`.state` (train step, eval step, embed step,
optimizer, metrics), :mod:`.metrics`, :mod:`.trials` and
:class:`.extractor.SpeakerEmbedder`. The JAX package's
``infer_xla_options`` and ``train_xla_options`` have no counterpart yet
(ROADMAP Queue 1 item 2, step capture)."""

from titanet_torch.train.metrics import (  # noqa: F401
    all_pairs_scores_labels,
    compute_eer,
    compute_mindcf,
    cosine_scores,
    cross_cosine_scores,
    get_test_metrics,
    get_train_val_metrics,
    metrics_from_class_counts,
    snorm_scores,
)
from titanet_torch.train.trials import (  # noqa: F401
    embed_trial_files,
    evaluate_trials,
    parse_trial_list,
    trial_scores,
)
from titanet_torch.train.state import (  # noqa: F401
    MetricsAcc,
    TrainState,
    accumulate_metrics,
    create_train_state,
    ema_eval_state,
    embed_step,
    embed_step_quantized,
    eval_step,
    init_metrics_acc,
    make_optimizer,
    train_step,
)
