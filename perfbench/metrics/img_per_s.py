"""Images stepped a second over the traced window, by the host's clock:
all the images the window counts (on several cards every card's, as
train_loop.py counts them, the padding not) over the length of its span.
The profiler slows the host's side of a step, so this reads below the
untraced rate; compare it only with traced runs."""


def read(t):
    images = t.counts.get('images')
    return images / t.window_s if images and t.window_s > 0 else None
