"""Training: optimizer, state and EMA, schedules, the supervised and SSOD
steps, checkpoints and the trainers."""
