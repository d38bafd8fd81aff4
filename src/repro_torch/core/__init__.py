"""The tuning loop: cells, mock-ups, guidelines, profiles, dispatch,
traces, measurement, cost model, tuner and selfcheck."""
